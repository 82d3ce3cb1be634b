"""Dry run of the port: plan every (arch x input-shape x mesh) with no card
and no allocation.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each combination over 512 fake CPU devices and reads XLA's
``memory_analysis()`` / ``cost_analysis()`` and the collectives of the
partitioned HLO.  The port has no compiler to ask; for every combination
this script

  1. lays out the production mesh's axis names and sizes
     (``sharding.MeshShape``: 16x16 a pod, 2x16x16 for two; no processes),
  2. builds the model on the meta device (shapes and dtypes, nothing
     allocated: llama4's 395 B parameters cost nothing) and the step's
     arguments as the reference lowers them: parameters in ``param_dtype``
     (bf16), the serving cache in bf16 (its recurrent states float32) laid
     out by ``cache_shardings`` (``seq_axis`` for long_500k and the
     ``seq_sharded`` variant), the inputs by ``data_spec``, and for
     training the AdamW state (a step count and two float32 moments laid
     out as the parameters),
  3. sums each argument's bytes on one device, exactly (a dimension split
     n ways holds ceil(dim / n) rows on a device): the counterpart of
     ``argument_size_in_bytes``, split into params, optimizer, cache and
     inputs,
  4. counts the step's FLOPs with ``torch.utils.flop_counter.
     FlopCounterMode`` over the plain versions on meta tensors (the matmul
     family: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and what ``einsum``
     lowers to) at one period of layers beside two periods, extrapolated
     to ``reps`` periods plus the tail, the reference's "x reps" fallback
     (marked ``approx`` the same way; ``--unrolled`` counts every layer);
     training counts the forward, the remat forward and the backward
     through autograd.  A MoE layer is counted as the dropless dispatch of
     T * K routed rows (meta tensors cannot read group sizes; ``MoE.
     grouped`` reads them to the host), the SSD scan in its chunked form
     (``kernels.ssd_scan.ops.ssd_scan_plain`` on meta tensors),
  5. records the bytes of the collectives the port's own code issues (the
     ``seq_sharded`` variant's combine: ``all_reduce`` of m, l and the
     accumulator a self-attention layer, and of the D-partial scores with
     ``d_axis``), from their shapes, and writes
     ``build/dryrun/<arch>__<shape>__<mesh>[__<variant>].json``.

XLA's own fields the port cannot produce (``output_size_in_bytes``,
``temp_size_in_bytes``, ``alias_size_in_bytes``,
``generated_code_size_in_bytes``, ``bytes_accessed``, ``optimal_seconds``
and the collectives of XLA's SPMD partitioner) are recorded as null, each
with its reason under ``null_fields``: never 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
      --shape decode_32k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import (ARCH_IDS, SHAPES, get_config,
                                          shape_supported)
from repro_torch.distributed import actsharding, sharding as SH
from repro_torch.launch.mesh import production_shape
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "../../../build/dryrun"))
META = torch.device("meta")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: the reference's fields that only XLA's compiler knows, and why each is
#: null here
NULL_FIELDS = {
    "output_size_in_bytes": "the reference's outputs are laid out by XLA "
                            "(out_shardings None); the port lowers nothing",
    "temp_size_in_bytes": "XLA's buffer assignment of the compiled step; "
                          "the port has no compiler",
    "alias_size_in_bytes": "XLA's donated-buffer aliasing; no compiled "
                           "step",
    "generated_code_size_in_bytes": "XLA's generated code; no compiled step",
    "bytes_accessed": "XLA's HLO cost analysis; no compiled step",
    "optimal_seconds": "XLA's HLO cost analysis; no compiled step",
    "xla_collectives": "XLA's SPMD partitioner inserts them; the port's "
                       "own collectives are under 'collectives'",
}


# ---------------------------------------------------------------------------
# Arguments and their layout
# ---------------------------------------------------------------------------


def mesh_for(kind: str, shape: tuple | None = None) -> SH.MeshShape:
    return SH.MeshShape(production_shape(multi_pod=(kind == "multipod"),
                                         shape=shape))


def rules_for(cfg: ArchConfig, mesh) -> dict:
    rules = SH.rules_for_config(cfg)
    if "pod" in SH.mesh_sizes(mesh):
        rules["embed"] = ("pod", "data")  # FSDP spans pods
    return rules


def device_bytes(shape, dtype: torch.dtype, spec, mesh) -> int:
    """Bytes of a leaf on one device under ``spec``: ceil(dim / n) rows
    along each dimension split n ways."""
    sizes = SH.mesh_sizes(mesh)
    n = 1
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n *= -(-int(dim) // SH._axis_size(sizes, ax))
    return n * torch.empty((), dtype=dtype, device=META).element_size()


def input_specs(cfg: ArchConfig, mode: str, B: int, S: int) -> dict:
    """{name: (shape, dtype)} of the step's inputs, as the reference's
    ``input_specs``."""
    i32, bf16 = torch.int32, torch.bfloat16
    if mode == "decode":
        return {"tokens": ((B, 1), i32), "lengths": ((B,), i32)}
    specs = {"tokens": ((B, S), i32)}
    if mode == "train":
        specs["mask"] = ((B, S), i32)
    if cfg.frontend:
        specs["frontend"] = ((B, cfg.frontend_len, cfg.frontend_dim), bf16)
    return specs


def seq_sharded_axes(shape_name: str) -> tuple:
    """(axis, batch_axis, d_axis) of the reference's ``seq_sharded``
    variant: S over "data" with D over "model" for long_500k (batch 1),
    else S over "model" with the batch over "data"."""
    if shape_name == "long_500k":
        return "data", None, "model"
    return "model", "data", None


def argument_bytes(cfg: ArchConfig, mode: str, B: int, S: int, mesh, *,
                   param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                   seq_shard: bool = False, seq_axis: str | None = None
                   ) -> dict:
    """Per-device bytes of the arguments of a ``mode`` step at batch B and
    length S (the decode cache's rows): {"params", "optimizer", "cache",
    "inputs", "total"}, the cache laid out by ``cache_shardings(seq_shard,
    seq_axis)``; and the port's own storage of the parameters
    ("port_params": the serving storage's dtypes, or the training
    storage's float32)."""
    model = T.Transformer(cfg, device=META, train=(mode == "train"))
    pspec = SH.param_shardings(model, mesh, rules_for(cfg, mesh))
    out = dict(params=0, optimizer=0, cache=0, inputs=0, port_params=0)
    for name, p in model.named_parameters():
        out["params"] += device_bytes(p.shape, param_dtype, pspec[name], mesh)
        out["port_params"] += device_bytes(p.shape, p.dtype, pspec[name],
                                           mesh)
        if mode == "train":    # AdamW's two float32 moments
            out["optimizer"] += 2 * device_bytes(p.shape, torch.float32,
                                                 pspec[name], mesh)
    if mode == "train":
        out["optimizer"] += 4                    # the int32 step count
    for name, (shape, dtype) in input_specs(cfg, mode, B, S).items():
        spec = () if name == "lengths" else \
            SH.data_spec(mesh, len(shape), batch=B)
        out["inputs"] += device_bytes(shape, dtype, spec, mesh)
    if mode != "train":
        cache = T.init_cache(cfg, B, S, cache_dtype, device=META)
        specs = SH.cache_shardings(cache, mesh, cfg, seq_shard=seq_shard,
                                   seq_axis=seq_axis)
        for layer, lspecs in zip(cache, specs):
            for leaf, spec in zip(layer, lspecs):
                out["cache"] += device_bytes(leaf.shape, leaf.dtype, spec,
                                             mesh)
    out["total"] = out["params"] + out["optimizer"] + out["cache"] + \
        out["inputs"]
    return out


def shape_argument_bytes(cfg: ArchConfig, shape_name: str, mesh, *,
                         seq_sharded: bool = False, **kw) -> dict:
    """``argument_bytes`` of the step of ``shape_name`` as the reference's
    dry run lowers it (long_500k's cache over "data"; the ``seq_sharded``
    variant's over its axis)."""
    sh = SHAPES[shape_name]
    return argument_bytes(
        cfg, sh["mode"], sh["global_batch"], sh["seq_len"], mesh,
        seq_shard=shape_name == "long_500k",
        seq_axis=seq_sharded_axes(shape_name)[0] if seq_sharded else None,
        **kw)


def seq_sharded_collectives(cfg: ArchConfig, shape_name: str, mesh
                            ) -> dict:
    """Output bytes a device's all-reduces carry in one step of the
    ``seq_sharded`` decode (``distributed.collectives``), from their
    shapes: a self-attention layer's m, l [B, H] and accumulator [B, H, D]
    float32, and with ``d_axis`` its D-partial scores [B, H, S_loc]."""
    sizes = SH.mesh_sizes(mesh)
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    axis, b_ax, d_ax = seq_sharded_axes(shape_name)
    B_loc = -(-B // (sizes[b_ax] if b_ax else 1))
    D_loc = -(-cfg.head_dim_ // (sizes[d_ax] if d_ax else 1))
    H = cfg.n_heads
    nbytes, count = 0, 0
    for kind in cfg.layer_kinds():
        if kind not in T.ATTN_KINDS:
            continue
        nbytes += 4 * (2 * B_loc * H + B_loc * H * D_loc)
        count += 3
        if d_ax:
            W = T.cache_window(cfg, kind, S)
            nbytes += 4 * B_loc * H * -(-W // sizes[axis])
            count += 1
    out = {k: 0.0 for k in _COLLECTIVES}
    out["all-reduce"] = float(nbytes)
    out.update({f"n_{k}": 0 for k in _COLLECTIVES})
    out["n_all-reduce"] = count
    return out


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


class DroplessCount(nn.Module):
    """A MoE layer's stand-in while the dry run counts FLOPs: every form
    (``grouped``, ``all_experts``, ``capacity``) as the dropless dispatch
    of the T * K routed rows through one expert's gated MLP (the count
    depends on the rows alone; meta tensors cannot read group sizes)."""

    def __init__(self, moe):
        super().__init__()
        self.moe = moe

    def _routed(self, x: torch.Tensor) -> torch.Tensor:
        B, S, E = x.shape
        K = self.moe.cfg.top_k
        xt = x.reshape(B * S, E)
        gate, _ = self.moe.route(xt)
        rows = xt[:, None].expand(B * S, K, E).reshape(B * S * K, E)
        y = self.moe._expert(0, rows).float() * gate.reshape(-1, 1)
        return y.view(B * S, K, E).sum(1).to(x.dtype).view(B, S, E)

    def grouped(self, x):
        return self._routed(x)

    def all_experts(self, x):
        return self._routed(x)

    def capacity(self, x, split=None):
        # split is None: a plan runs on no mesh
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ self.moe.router, -1)
        return self._routed(x), probs


def _meta_model(cfg: ArchConfig, train: bool) -> T.Transformer:
    model = T.Transformer(cfg, device=META, train=train)
    for blk in model.blocks:
        if blk.moe:
            blk.ffn = DroplessCount(blk.ffn)
    return model


def _inputs(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16):
    tokens = torch.zeros((B, S), dtype=torch.int64, device=META)
    frontend = None
    if cfg.frontend:
        frontend = torch.zeros((B, cfg.frontend_len, cfg.frontend_dim),
                               dtype=dtype, device=META)
    return tokens, frontend


def step_flops(cfg: ArchConfig, mode: str, B: int, S: int) -> int:
    """FLOPs of one ``mode`` step of ``cfg`` over B sequences of S tokens
    (decode: one token against S cache rows), every layer traced on meta
    tensors."""
    model = _meta_model(cfg, train=(mode == "train"))
    with FlopCounterMode(display=False) as fc:
        if mode == "train":
            tokens, frontend = _inputs(cfg, B, S)
            logits, aux = T.forward(model, tokens, frontend, remat=True,
                                    plain=True)
            (logits.float().logsumexp(-1).sum() + aux).backward()
        elif mode == "prefill":
            tokens, frontend = _inputs(cfg, B, S)
            cache = T.init_cache(cfg, B, S, torch.bfloat16, device=META)
            T.prefill(model, tokens, cache, frontend, plain=True)
        else:
            tokens, _ = _inputs(cfg, B, 1)
            lengths = torch.zeros((B,), dtype=torch.int32, device=META)
            cache = T.init_cache(cfg, B, S, torch.bfloat16, device=META)
            T.decode_step(model, tokens, lengths, cache, plain=True)
    return int(fc.get_total_flops())


def count_flops(cfg: ArchConfig, mode: str, B: int, S: int, *,
                unrolled: bool = False) -> dict:
    """{"flops_total", "approx", "reps"}: every layer traced
    (``unrolled``, or at most two periods), or one period and two periods
    (each with the tail) traced and their difference added ``reps - 1``
    times."""
    period, reps = cfg.period, cfg.n_layers // cfg.period
    tail = cfg.n_layers - reps * period
    if unrolled or reps <= 2:
        return dict(flops_total=step_flops(cfg, mode, B, S), approx=False,
                    reps=reps)
    one = step_flops(dataclasses.replace(cfg, n_layers=period + tail),
                     mode, B, S)
    two = step_flops(dataclasses.replace(cfg, n_layers=2 * period + tail),
                     mode, B, S)
    return dict(flops_total=one + (reps - 1) * (two - one), approx=True,
                reps=reps)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def plan(arch: str, shape_name: str, mesh_kind: str, *,
         variant: str = "", unrolled: bool = False,
         mesh_shape: tuple | None = None) -> dict:
    """The record of one combination (``status`` "ok", "skipped" or an
    exception propagates)."""
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "skipped"}
    if variant:
        rec["variant"] = variant
    if not shape_supported(arch, shape_name):
        rec["reason"] = "full-attention arch: long_500k skipped (DESIGN.md)"
        return rec
    if variant == "seq_sharded" and SHAPES[shape_name]["mode"] != "decode":
        rec["reason"] = "seq_sharded is a decode variant"
        return rec
    mesh = mesh_for(mesh_kind, mesh_shape)
    t0 = time.perf_counter()
    if variant == "act_sharding":
        actsharding.enable(SH.batch_axes(mesh))
    try:
        args = shape_argument_bytes(cfg, shape_name, mesh,
                                    seq_sharded=variant == "seq_sharded")
        t_args = time.perf_counter() - t0
        sh = SHAPES[shape_name]
        fl = count_flops(cfg, sh["mode"], sh["global_batch"], sh["seq_len"],
                         unrolled=unrolled)
    finally:
        actsharding.disable()
    n = mesh.size
    per_dev = fl["flops_total"] / n
    coll = seq_sharded_collectives(cfg, shape_name, mesh) \
        if variant == "seq_sharded" else \
        {**{k: 0.0 for k in _COLLECTIVES},
         **{f"n_{k}": 0 for k in _COLLECTIVES}}
    rec.update(
        status="ok", n_devices=n, mesh_shape=SH.mesh_sizes(mesh),
        argument_size_in_bytes=args["total"],
        argument_bytes={k: args[k] for k in ("params", "optimizer", "cache",
                                             "inputs")},
        port_param_bytes=args["port_params"],
        param_dtype="bfloat16",
        flops=per_dev, flops_total=fl["flops_total"],
        unrolled={"flops": per_dev, "approx": fl["approx"],
                  "reps": fl["reps"]},
        flops_counted=("matmul family (FlopCounterMode) over the plain "
                       "versions on meta tensors; "
                       + ("forward + remat forward + backward"
                          if SHAPES[shape_name]["mode"] == "train"
                          else "one step")),
        collectives=coll,
        act_sharding=variant == "act_sharding",
        plan_s=round(time.perf_counter() - t0, 2),
        args_s=round(t_args, 2))
    if cfg.n_experts:
        rec["moe"] = ("counted as the dropless dispatch of T*K routed rows "
                      "(meta tensors cannot read group sizes)")
    if "ssd" in cfg.layer_pattern:
        rec["ssd"] = "scan counted in its chunked form (chunk 128)"
    rec.update({k: None for k in NULL_FIELDS})
    rec["null_fields"] = dict(NULL_FIELDS)
    return rec


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            out_dir: str = RESULTS_DIR, force: bool = False,
            variant: str = "", unrolled: bool = False,
            mesh_shape: tuple | None = None) -> dict:
    """Plan one combination and write its record (an existing record is
    read back unless ``force``)."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    if variant:
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        rec = plan(arch, shape_name, mesh_kind, variant=variant,
                   unrolled=unrolled, mesh_shape=mesh_shape)
        if rec["status"] == "ok":
            print(f"[dryrun] {tag}: OK plan={rec['plan_s']:.1f}s "
                  f"flops/dev={rec['flops']:.3g}")
            print(f"[dryrun] {tag} memory: args="
                  f"{rec['argument_size_in_bytes'] / 2**30:.2f}GiB "
                  + " ".join(f"{k}={v / 2**30:.2f}GiB"
                             for k, v in rec["argument_bytes"].items()))
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] {tag}: FAILED {type(e).__name__}: {e}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--unrolled", action="store_true",
                    help="trace every layer for an exact FLOP count")
    ap.add_argument("--seq-sharded", action="store_true",
                    help="decode shapes: the sequence-sharded variant")
    ap.add_argument("--act-sharding", action="store_true",
                    help="the activation-sharding variant")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    variant = "seq_sharded" if args.seq_sharded else \
        "act_sharding" if args.act_sharding else ""
    if args.all:
        combos = [(a, s, m) for a in ARCH_IDS for s in SHAPES
                  for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape, m) for m in meshes]
    ok = err = skip = 0
    for a, s, m in combos:
        rec = run_one(a, s, m, out_dir=args.out, force=args.force,
                      variant=variant, unrolled=args.unrolled)
        ok += rec["status"] == "ok"
        err += rec["status"] == "error"
        skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {ok} ok, {err} failed, {skip} skipped")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())

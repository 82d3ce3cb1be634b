"""One rank of the 2x2 gloo job behind ``tests/test_torch_collectives.py``.

    PYTHONPATH=src python tests/_torch_dist_job.py RANK WORLD PORT OUT

Joins a CPU process group of WORLD (4) ranks through gloo at
tcp://localhost:PORT, builds the port's ("data", "model") = (2, 2) dev mesh
and runs every case of ``CASES`` on this rank's shards of the same seeded
inputs; writes its local results to OUT/rank{RANK}.npz.  Imports torch and
the port only (the test process computes the JAX package's results).
"""
from __future__ import annotations

import sys
import zlib

import numpy as np

#: sequence-sharded attention cases: shapes, lengths, window and the mesh
#: axes of the sequence, the batch and the head dim (S_loc = S / 2)
CASES = {
    "seq_data_batch_model_w0": dict(B=4, H=8, KvH=4, D=64, S=256,
                                    lengths=[100, 220, 128, 7], window=0,
                                    axis="data", batch_axis="model"),
    "seq_data_batch_model_w64": dict(B=4, H=8, KvH=4, D=64, S=256,
                                     lengths=[100, 220, 128, 7], window=64,
                                     axis="data", batch_axis="model"),
    "seq_data_d_model": dict(B=2, H=4, KvH=2, D=32, S=128,
                             lengths=[128, 77], window=0, axis="data",
                             d_axis="model"),
    # every valid row in the first shard: the second contributes nothing
    "length_in_first_shard": dict(B=2, H=8, KvH=4, D=64, S=256,
                                  lengths=[50, 127], window=0, axis="data",
                                  batch_axis="model"),
    # the window wholly in the second shard: the first has no row
    "window_in_second_shard": dict(B=2, H=8, KvH=4, D=64, S=256,
                                   lengths=[200, 256], window=64,
                                   axis="data", batch_axis="model"),
    # lengths on and beside the shard boundary, and none at all
    "shard_boundary": dict(B=4, H=8, KvH=4, D=64, S=256,
                           lengths=[128, 129, 1, 0], window=0, axis="data",
                           batch_axis="model"),
}
#: the one-slot cache update: S over "data", the batch over "model"
UPDATE = dict(B=4, S=64, KvH=2, D=16, slots=[3, 40, 31, 32])
#: decode_step with the hooks: the reduced gemma3, a 39-token prompt, the
#: cache's rows over "data" and the batch over "model"
DECODE = dict(arch="gemma3-12b", B=2, S=40, max_len=48)


def case_inputs(name: str) -> dict:
    """The full (unsharded) float32 inputs of a case, from its name."""
    c = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, H, KvH, D, S = (c[k] for k in ("B", "H", "KvH", "D", "S"))
    return dict(
        q=rng.standard_normal((B, H, D)).astype(np.float32),
        k=rng.standard_normal((B, S, KvH, D)).astype(np.float32),
        v=rng.standard_normal((B, S, KvH, D)).astype(np.float32),
        lengths=np.asarray(c["lengths"], np.int32))


def update_inputs() -> dict:
    rng = np.random.default_rng(7)
    B, S, KvH, D = (UPDATE[k] for k in ("B", "S", "KvH", "D"))
    return dict(
        ck=rng.standard_normal((B, S, KvH, D)).astype(np.float32),
        cv=rng.standard_normal((B, S, KvH, D)).astype(np.float32),
        k_new=rng.standard_normal((B, KvH, D)).astype(np.float32),
        v_new=rng.standard_normal((B, KvH, D)).astype(np.float32),
        slot=np.asarray(UPDATE["slots"], np.int32))


def part(n: int, shards: int, i: int) -> slice:
    """Shard i of n rows split ``shards`` ways."""
    step = n // shards
    return slice(i * step, (i + 1) * step)


def main(rank: int, world: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.distributed.collectives import (
        make_seq_sharded_cache_update, make_seq_sharded_decode_attn)
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer as T
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    mesh = make_dev_mesh(2, 2, device="cpu")
    at = {a: mesh.get_local_rank(a) for a in ("data", "model")}
    res = {"coords": np.asarray([at["data"], at["model"]])}
    for name, c in CASES.items():
        x = {k: torch.as_tensor(v) for k, v in case_inputs(name).items()}
        b = part(c["B"], 2, at[c["batch_axis"]]) if c.get("batch_axis") \
            else slice(None)
        s = part(c["S"], 2, at[c["axis"]])
        d = part(c["D"], 2, at[c["d_axis"]]) if c.get("d_axis") \
            else slice(None)
        fn = make_seq_sharded_decode_attn(mesh, c["axis"],
                                          c.get("batch_axis"),
                                          c.get("d_axis"))
        res[name] = fn(x["q"][b, :, d].contiguous(),
                       x["k"][b, s, :, d].contiguous(),
                       x["v"][b, s, :, d].contiguous(),
                       x["lengths"][b].contiguous(),
                       window=c["window"]).numpy()
    u = {k: torch.as_tensor(v) for k, v in update_inputs().items()}
    b, s = part(UPDATE["B"], 2, at["model"]), part(UPDATE["S"], 2,
                                                    at["data"])
    ck, cv = u["ck"][b, s].clone(), u["cv"][b, s].clone()
    upd = make_seq_sharded_cache_update(mesh, "data", "model")
    upd(ck, cv, u["k_new"][b], u["v_new"][b], u["slot"][b])
    res["update_k"], res["update_v"] = ck.numpy(), cv.numpy()

    cfg = get_reduced_config(DECODE["arch"])
    B, S, max_len = DECODE["B"], DECODE["S"], DECODE["max_len"]
    model = T.init_model(0, cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)))
    cache = T.init_cache(cfg, B, max_len, torch.float32, device="cpu")
    _, lengths = T.prefill(model, tokens[:, :S - 1], cache)
    b = part(B, 2, at["model"])
    local = [tuple(t[b, part(t.shape[1], 2, at["data"])].clone()
                   for t in layer) for layer in cache]
    whole = [tuple(t.clone() for t in layer) for layer in cache]
    res["logits_plain"] = T.decode_step(model, tokens[:, S - 1:], lengths,
                                        whole)[b].numpy()
    res["logits_hooked"] = T.decode_step(
        model, tokens[b, S - 1:], lengths[b], local,
        decode_attn_fn=make_seq_sharded_decode_attn(mesh, "data", "model"),
        decode_update_fn=make_seq_sharded_cache_update(mesh, "data",
                                                       "model")).numpy()
    for li, (lw, ll) in enumerate(zip(whole, local)):
        for j, (w, loc) in enumerate(zip(lw, ll)):
            res[f"cache_plain_{li}_{j}"] = \
                w[b, part(w.shape[1], 2, at["data"])].numpy()
            res[f"cache_hooked_{li}_{j}"] = loc.numpy()
    # the production mesh refuses this world of 4 ranks, and the launcher
    # given no mesh
    from repro_torch.launch import mesh as M, train as t_train
    for key, fn in (
            ("mesh_error", lambda: M.make_production_mesh(device="cpu")),
            ("launcher_error", lambda: t_train.train(
                t_train.parser().parse_args(["--arch", "starcoder2-3b"]),
                device="cpu"))):
        try:
            fn()
            res[key] = np.asarray("")
        except ValueError as e:
            res[key] = np.asarray(str(e))
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

"""The port's sharding rules and dry run (``repro_torch.distributed.
sharding``, ``repro_torch.launch.dryrun``) against the JAX package's, at
the production mesh shapes with no devices.

The reference's functions read only ``mesh.shape`` and ``mesh.axis_names``,
so they run here on a stub mesh of 256 or 512 "devices"; the port's run on
``sharding.MeshShape``.  For every arch's full config, on the meshes
(16, 16), (2, 16, 16) and (32, 8): every parameter's spec (matched through
``convert.reference_path``; a stacked leaf's spec is the port's behind a
leading None), every serving-cache leaf's spec at decode_32k and long_500k
(seq_axis None, "data", "model") and ``data_spec`` are equal.  The dry
run's per-device argument bytes equal an independent sum over the
reference's own leaves and specs; on a 1x1 mesh they equal XLA's compiled
``argument_size_in_bytes``; its FLOPs of a reduced dense arch equal twice
its GEMMs' multiply-adds, counted from the config here.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import (ARCH_IDS, SHAPES, get_config,
                                    get_reduced_config)
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.models import convert, transformer as T
from _torch_parity import one_torch_thread, port_arch

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (32, 8): ("data", "model")}
CACHE_SHAPES = ("decode_32k", "long_500k")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def stub(shape, names):
    """A mesh as the reference's functions read one: names and sizes."""
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=tuple(names))


def port_mesh(shape, names):
    return SH.MeshShape(dict(zip(names, shape)))


_REF: dict = {}


def reference(arch: str) -> dict:
    """The reference's abstract parameters, logical axes and caches of
    ``arch`` (one ``eval_shape`` each, shared by the tests of a worker)."""
    if arch not in _REF:
        cfg = get_config(arch)
        box = {}

        def init():
            p, a = JT.init_model(0, cfg)
            box["axes"] = a
            return JT.init_model_params_only(0, cfg)
        shapes = jax.eval_shape(init)
        caches = {s: jax.eval_shape(lambda s=s: JT.init_cache(
            cfg, SHAPES[s]["global_batch"], SHAPES[s]["seq_len"],
            jnp.bfloat16)) for s in CACHE_SHAPES + ("decode_32k",)}
        _REF[arch] = dict(cfg=cfg, axes=box["axes"], shapes=shapes,
                          caches=caches)
    return _REF[arch]


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _entries(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    """Every parameter's spec, on each production mesh shape, equals the
    reference's ``spec_for`` of its leaf (the stacked axis dropped)."""
    ref = reference(arch)
    cfg = port_arch(ref["cfg"])
    model = T.Transformer(cfg, device="meta")
    axes = T.param_axes(model)
    checked = 0
    for shape, names in MESHES.items():
        rules = JSH.rules_for_config(ref["cfg"])
        got = SH.param_shardings(model, port_mesh(shape, names),
                                 SH.rules_for_config(cfg))
        for name, p in model.named_parameters():
            path, idx = convert.reference_path(name, cfg)
            r_axes = _lookup(ref["axes"], path)
            r_shape = _lookup(ref["shapes"], path).shape
            want = JSH.spec_for(r_axes, r_shape, stub(shape, names), rules)
            want = _entries(want, len(r_shape))
            if idx is not None:
                assert r_axes[0] == "layers" and want[0] is None, name
                want, r_axes = want[1:], r_axes[1:]
            assert axes[name] == tuple(r_axes), name
            assert tuple(p.shape) == tuple(r_shape[idx is not None:]), name
            assert got[name] == want, (name, shape)
            checked += 1
    assert checked == 3 * len(axes)


def _ref_cache_specs(ref, shape_name, mesh, seq_shard, seq_axis):
    """The reference's spec of each layer's cache leaves, in the port's
    per-layer order, unstacked."""
    cfg = ref["cfg"]
    cache = ref["caches"][shape_name]
    period, reps = cfg.period, cfg.n_layers // cfg.period
    if seq_shard and seq_axis is None:
        seq_axis = "data"
    out = []
    for li, kind in enumerate(cfg.layer_kinds()):
        r, j = divmod(li, period)
        stacked = r < reps
        node = cache["blocks"][f"pos{j}"] if stacked else \
            cache["tail"][li - reps * period]
        specs = []
        for name in SH.cache_names(port_arch(cfg), kind):
            spec = _entries(JSH.cache_spec(mesh, (name,), node[name].shape,
                                           cfg, stacked=stacked,
                                           seq_axis=seq_axis),
                            len(node[name].shape))
            specs.append(spec[1:] if stacked else spec)
        out.append(tuple(specs))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    """Every leaf of the port's ``init_cache`` at decode_32k and long_500k,
    with seq_axis None, "data" and "model" (and long_500k's ``seq_shard``),
    gets the reference's spec of its leaf."""
    ref = reference(arch)
    cfg = port_arch(ref["cfg"])
    for shape_name in CACHE_SHAPES:
        sh = SHAPES[shape_name]
        cache = T.init_cache(cfg, sh["global_batch"], sh["seq_len"],
                             device="meta")
        names = [SH.cache_names(cfg, k) for k in cfg.layer_kinds()]
        assert [len(layer) for layer in cache] == [len(n) for n in names]
        for shape, axes in MESHES.items():
            for seq_shard, seq_axis in ((False, None), (True, None),
                                        (False, "data"), (False, "model")):
                got = SH.cache_shardings(cache, port_mesh(shape, axes), cfg,
                                         seq_shard=seq_shard,
                                         seq_axis=seq_axis)
                want = _ref_cache_specs(ref, shape_name, stub(shape, axes),
                                        seq_shard, seq_axis)
                assert got == want, (shape_name, shape, seq_axis)


def test_data_spec_batch_axes_and_placements():
    """``data_spec`` / ``batch_axes`` equal the reference's on every mesh
    and batch; ``placements`` maps a spec onto a 1x1 ``DeviceMesh`` (a
    tuple entry shards its dimension over both axes in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_dev_mesh
    for shape, names in MESHES.items():
        ref_mesh, mesh = stub(shape, names), port_mesh(shape, names)
        assert SH.batch_axes(mesh) == JSH.batch_axes(ref_mesh)
        for ndim in (1, 2, 3):
            for batch in (None, 1, 16, 32, 128, 256):
                want = JSH.data_spec(ref_mesh, ndim, batch=batch)
                assert SH.data_spec(mesh, ndim, batch=batch) == \
                    _entries(want, ndim)
    dm = make_dev_mesh(1, 1, device="cpu")
    assert SH.mesh_sizes(dm) == {"data": 1, "model": 1}
    assert SH.placements((None, "model", "data"), dm) == [Shard(2),
                                                          Shard(1)]
    assert SH.placements((("data", "model"), None), dm) == [Shard(0),
                                                            Shard(0)]
    assert SH.placements((None, None), dm) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        SH.placements((("model", "data"),), dm)


def _ref_argument_bytes(ref, shape_name, mesh) -> int:
    """Per-device argument bytes of the reference's dry-run lowering of
    ``shape_name``, summed over its own leaves and specs."""
    cfg = ref["cfg"]
    sizes = dict(mesh.shape)
    rules = JSH.rules_for_config(cfg)
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]

    def nbytes(shape, dtype, spec):
        spec = _entries(spec, len(shape))
        n = 1
        for dim, ax in zip(shape, spec):
            n *= -(-dim // JSH._axis_size(types.SimpleNamespace(
                shape=sizes), ax))
        return n * jnp.dtype(dtype).itemsize

    total = 0
    axes = jax.tree.leaves(ref["axes"], is_leaf=lambda x: isinstance(x,
                                                                   tuple))
    shapes = jax.tree.leaves(ref["shapes"])
    assert len(axes) == len(shapes)
    for ax, s in zip(axes, shapes):
        spec = JSH.spec_for(ax, s.shape, mesh, rules)
        total += nbytes(s.shape, s.dtype, spec)
        if sh["mode"] == "train":
            total += 2 * nbytes(s.shape, jnp.float32, spec)
    if sh["mode"] == "train":
        total += jnp.dtype(jax.eval_shape(jopt.init,
                                          ref["shapes"]).step.dtype).itemsize
        total += 2 * nbytes((B, S), jnp.int32,
                            JSH.data_spec(mesh, 2, batch=B))
        if cfg.frontend:
            total += nbytes((B, cfg.frontend_len, cfg.frontend_dim),
                            jnp.bfloat16, JSH.data_spec(mesh, 3, batch=B))
        return total
    total += nbytes((B, 1), jnp.int32, JSH.data_spec(mesh, 2, batch=B))
    total += B * 4                                   # lengths, replicated
    cache = ref["caches"][shape_name]
    for key, node in (("blocks", cache["blocks"]), ("tail", cache["tail"])):
        items = node.items() if key == "blocks" else enumerate(node)
        for _, layer in items:
            for name, leaf in layer.items():
                spec = JSH.cache_spec(mesh, (name,), leaf.shape, cfg,
                                      stacked=key == "blocks")
                total += nbytes(leaf.shape, leaf.dtype, spec)
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_argument_bytes_match_reference_leaves(arch):
    """The dry run's per-device argument bytes at decode_32k and train_4k
    on the pod mesh equal a sum over the reference's leaves under its
    specs (bf16 parameters and cache, float32 AdamW moments)."""
    ref = reference(arch)
    cfg = port_arch(ref["cfg"])
    mesh = port_mesh((16, 16), ("data", "model"))
    for shape_name in ("decode_32k", "train_4k"):
        got = DR.shape_argument_bytes(cfg, shape_name, mesh)
        assert got["total"] == _ref_argument_bytes(
            ref, shape_name, stub((16, 16), ("data", "model"))), shape_name


def test_dryrun_bytes_match_compiled_memory_analysis():
    """On a 1x1 mesh the dry run's argument bytes of the reduced mixtral's
    decode (float32 parameters and cache, B 4, 64 rows) equal XLA's
    ``argument_size_in_bytes`` of the reference's compiled step, lowered
    as ``tests/test_system.py`` lowers it."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_dev_mesh
    cfg = get_reduced_config("mixtral-8x22b")
    mesh = make_dev_mesh(1, 1)
    rules = JSH.rules_for_config(cfg)
    axes = JT.init_model_axes(cfg)
    pshapes = jax.eval_shape(
        lambda: JT.init_model_params_only(0, cfg, dtype=jnp.float32))
    pshard = JSH.param_shardings(axes, pshapes, mesh, rules)
    cspecs = jax.eval_shape(lambda: JT.init_cache(cfg, 4, 64, jnp.float32))
    cshard = JSH.cache_shardings(cspecs, mesh, cfg)
    with mesh:
        fn = jax.jit(
            lambda p, t, l, c: JT.decode_step(p, cfg, t, l, c),
            in_shardings=(pshard, NamedSharding(mesh, P()),
                          NamedSharding(mesh, P()), cshard),
            out_shardings=(None, cshard))
        compiled = fn.lower(pshapes,
                            jax.ShapeDtypeStruct((4, 1), jnp.int32),
                            jax.ShapeDtypeStruct((4,), jnp.int32),
                            cspecs).compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    got = DR.argument_bytes(port_arch(cfg), "decode", 4, 64,
                            port_mesh((1, 1), ("data", "model")),
                            param_dtype=torch.float32,
                            cache_dtype=torch.float32)
    assert got["total"] == want


def _dense_gemm_flops(cfg, mode: str, B: int, S: int) -> int:
    """2 x the multiply-adds of a dense decoder's GEMMs, from the config:
    the projections and MLP of every layer, the plain attention's two
    products over every (query, key) pair it computes (a prefill's
    masked square; a decode step's S cache rows) and the head (the last
    token's logits in a prefill, every token's in training)."""
    E, H, KvH, Dh, Fd, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim_, cfg.d_ff, cfg.vocab)
    g = 2 if cfg.gated_mlp else 1
    T_ = B * (1 if mode == "decode" else S)
    per_layer = (T_ * E * (H + 2 * KvH) * Dh + T_ * H * Dh * E
                 + T_ * E * g * Fd + T_ * Fd * E
                 + 2 * T_ * H * S * Dh)
    head = (B if mode == "prefill" else T_) * E * V
    return 2 * (cfg.n_layers * per_layer + head)


def test_dryrun_counts_moe_training_flops():
    """The training step of a MoE arch (reduced mixtral: every layer MoE,
    its training dispatch ``MoE.capacity`` counted as the dropless one)
    traces on meta tensors: more FLOPs than its prefill of the same
    tokens, and the "x reps" count equals the every-layer count."""
    cfg = port_arch(get_reduced_config("mixtral-8x22b", n_layers=4))
    train = DR.count_flops(cfg, "train", 2, 32)
    assert train["flops_total"] > DR.count_flops(cfg, "prefill", 2,
                                                 32)["flops_total"] > 0
    assert train["flops_total"] == DR.count_flops(
        cfg, "train", 2, 32, unrolled=True)["flops_total"]


def test_dryrun_flops_of_reduced_dense_arch():
    """FLOPs counted over the plain versions on meta tensors equal 2 x the
    GEMMs' multiply-adds for the reduced qwen2.5 (dense, global attention)
    at prefill and decode; the "x reps" count of a deeper reduced gemma3
    equals its every-layer count; the CLI writes a record with the null
    fields and their reasons."""
    cfg = port_arch(get_reduced_config("qwen2.5-14b", n_layers=3))
    for mode, B, S in (("prefill", 2, 48), ("decode", 3, 40)):
        got = DR.count_flops(cfg, mode, B, S)
        assert got["flops_total"] == _dense_gemm_flops(cfg, mode, B, S), mode
    deep = port_arch(get_reduced_config("gemma3-12b", n_layers=20))
    for mode in ("prefill", "decode", "train"):
        approx = DR.count_flops(deep, mode, 2, 32)
        exact = DR.count_flops(deep, mode, 2, 32, unrolled=True)
        assert approx["approx"] and approx["reps"] == 3
        assert approx["flops_total"] == exact["flops_total"], mode
    rec = DR.plan("gemma3-12b", "decode_32k", "pod", variant="seq_sharded")
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["temp_size_in_bytes"] is None
    assert set(rec["null_fields"]) == set(DR.NULL_FIELDS)
    assert rec["collectives"]["n_all-reduce"] == 3 * 48
    assert math.isclose(rec["flops"] * 256, rec["flops_total"])
    assert DR.plan("qwen2.5-14b", "long_500k", "pod")["status"] == "skipped"
    np.testing.assert_equal(rec["argument_size_in_bytes"],
                            sum(rec["argument_bytes"].values()))

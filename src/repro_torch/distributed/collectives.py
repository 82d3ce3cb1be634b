"""Hand-scheduled collectives: decode attention with the KV cache's
sequence dimension sharded across a mesh axis.

Port of ``src/repro/distributed/collectives.py``.  Each shard computes a
partial flash-softmax over its local KV slice, float32 (m, l, acc); the
partials combine with one all-reduce MAX and two all-reduce SUMs of
[B, H(, D)] instead of gathering the multi-GB cache.  The reference runs
its ``local_fn`` under ``shard_map``; here the returned functions take the
calling rank's local shards, as ``local_fn`` does, and reduce over the
process groups of a ``DeviceMesh`` (``mesh.get_group(axis)``).  They use
``all_reduce`` alone, which gloo also runs on CUDA tensors (two ranks on
one card, where NCCL refuses a second rank on the same device).

Without ``d_axis`` a shard's partial is one launch of the decode-attention
kernel (``kernels.decode_attention.ops.decode_attention_partial``, its
plain version on a CPU tensor): q in float32, as ``local_fn`` casts it,
and each sequence's length shifted by the shard's offset, ``lengths -
shard * S_loc``, which selects the shard's rows of the global range (the
window too); a shard with no rows gives m = -1e30 and l = 0.  With
``d_axis`` the head dim is sharded too: each shard's scores are partial
sums over its slice of D and must be summed across ranks before the
softmax, which a kernel that owns its softmax cannot do, so that path is
torch ops, as the reference's is ``einsum``.

The functions carry ``seq_shards``, the axis size: ``transformer.
decode_step`` reads it to see a layer's global cache rows (local rows
times it), where it computes slots and valid lengths.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import mesh_sizes
from repro_torch.kernels.decode_attention import ops as da_ops


def _combine(acc, m, l, group) -> torch.Tensor:
    """out = sum_r acc_r corr_r / max(sum_r l_r corr_r, 1e-30) over the
    group, corr_r = exp(m_r - max_r m_r): the reference's pmax + two psums.
    acc [B, H, D] unnormalised float32; m, l [B, H]."""
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)
    lc = l * corr
    acc = acc * corr[..., None]
    dist.all_reduce(lc, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc / torch.clamp_min(lc, 1e-30)[..., None]


def make_seq_sharded_decode_attn(mesh, axis: str = "data",
                                 batch_axis: str | None = None,
                                 d_axis: str | None = None):
    """Returns fn(q, k, v, lengths, *, window=0) -> [B, H, D] (q's dtype)
    on the calling rank's shards: k, v [B, S_loc, KvH, D] its slice of the
    sequence over ``axis`` (and of the batch over ``batch_axis``, and of D
    over ``d_axis``), q [B, H, D] and lengths [B] (global positions) its
    batch rows.  ``batch_axis`` needs nothing of the function: a rank
    holds its batch rows and their lengths.  ``d_axis``: the scores'
    D-partials are summed over that axis before the softmax (torch ops,
    module docstring)."""
    group = mesh.get_group(axis)
    shard = mesh.get_local_rank(axis)
    d_group = mesh.get_group(d_axis) if d_axis else None
    n_d = mesh_sizes(mesh)[d_axis] if d_axis else 1

    def fn(q, k, v, lengths, *, window: int = 0):
        S_loc = k.shape[1]
        if not d_axis:
            local = (lengths - shard * S_loc).to(torch.int32).contiguous()
            out, ml = da_ops.decode_attention_partial(q, k, v, local,
                                                      window=window)
            m, l = ml[..., 0], ml[..., 1]
            return _combine(out * l[..., None], m, l, group).to(q.dtype)
        B, H, D_loc = q.shape
        KvH = k.shape[2]
        G = H // KvH
        scale = (D_loc * n_d) ** -0.5
        qg = q.reshape(B, KvH, G, D_loc).float()
        s = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=d_group)
        idx = shard * S_loc + torch.arange(S_loc, device=q.device)
        ln = lengths.to(torch.int64)[:, None]
        valid = idx[None, :] < ln
        if window > 0:
            valid = valid & (idx[None, :] >= ln - window)
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, -1e30)
        m = s.amax(-1)
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        acc = torch.einsum("bngs,bsnd->bngd", p, v.float())
        out = _combine(acc, m, p.sum(-1), group)
        return out.reshape(B, H, D_loc).to(q.dtype)

    fn.seq_shards = mesh_sizes(mesh)[axis]
    return fn


def make_seq_sharded_cache_update(mesh, axis: str = "data",
                                  batch_axis: str | None = None,
                                  d_axis: str | None = None):
    """Returns fn(cache_k, cache_v, k_new, v_new, slot) -> (cache_k,
    cache_v): writes one new K/V token (k_new, v_new [B, KvH, D] in the
    rank's shards) at global row ``slot`` [B] of the rank's slice of the
    sequence-sharded cache, in place, on the rank that owns the row only
    (the others write their row back); never gathers the cache."""
    shard = mesh.get_local_rank(axis)

    def fn(cache_k, cache_v, k_new, v_new, slot):
        B, S_loc = cache_k.shape[:2]
        local = slot.to(torch.int64) - shard * S_loc
        in_range = ((local >= 0) & (local < S_loc))[:, None, None]
        idx = torch.clamp(local, 0, S_loc - 1)
        b = torch.arange(B, device=cache_k.device)
        for cache, new in ((cache_k, k_new), (cache_v, v_new)):
            cache[b, idx] = torch.where(in_range, new.to(cache.dtype),
                                        cache[b, idx])
        return cache_k, cache_v

    fn.seq_shards = mesh_sizes(mesh)[axis]
    return fn

"""Oracle for the token-bucket kernel: the core module's semantics.

Delegates to ``repro_torch.core.token_bucket`` (``advance`` then
``try_admit``), as ``src/repro/kernels/token_bucket/ref.py`` does, so the
kernel, its plain version and the engine share one definition.
"""
from __future__ import annotations

from repro_torch.core import token_bucket as tb


def token_bucket_step(tokens, cyc, refill_rate, bkt_size, interval, mode,
                      elapsed_cycles, msg_cost_bytes, want):
    """One shaping interval for N flows (elementwise).

    Returns (new_tokens, new_cyc, admitted)."""
    state = tb.TBState(tokens, cyc, refill_rate, bkt_size, interval, mode)
    state = tb.advance(state, elapsed_cycles)
    state, admitted = tb.try_admit(state, msg_cost_bytes, want)
    return state.tokens, state.cyc, admitted

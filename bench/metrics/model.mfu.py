"""Model FLOPs of every prefill and decode step of the window, counted
from the configuration's shapes, the token counts and the contexts
(``bench/arith.py``), over the window's seconds times the H100 SXM's dense
bf16 peak, in percent."""
from bench import arith


def read(run):
    cfg = run.cfg
    flops = sum(arith.prefill_flops(cfg, c.tokens)
                for c in run.window(run.log.prefills))
    flops += sum(arith.decode_flops(cfg, c.contexts)
                 for c in run.window(run.log.decodes))
    return 100.0 * flops / ((run.t1 - run.t0) * arith.PEAK_BF16_FLOPS)

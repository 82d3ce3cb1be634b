"""The comparison that decides ``correct``.

The numbers, each beside its limit:

* ``gap_share`` and ``gap_max``: after the window, a sample drawn from the
  seed of the requests the window finished (the longest among them, then
  others in the seed's order up to the cell's ``sample_tokens``) is run
  once through the plain float32 reference (``bench/reference``) over each
  prompt with its served tokens.  At each position, the served token's gap
  below the reference's best logit, in units of the spread of the
  reference's logits there: ``gap_share`` is the share of served tokens
  whose gap exceeds ``GAP_TAU``, ``gap_max`` the widest gap.
  Every served token is greedy, so a correct program reads gaps of
  rounding size (and, in a mixture of experts, the rare token whose
  routing sat on a tie that rounding tipped).  A cell compares those the
  cell file gives a limit for, set from the program's readings on a dozen
  seeds and the control's (the same reference in float8 e4m3,
  ``control_share`` and ``control_max``, which ``control_checks`` holds
  to the same limits).
* ``token_count_errors``: requests whose generated tokens are not what they
  asked for (a finished request: exactly ``max_new_tokens``; any other: at
  most that).  Limit 0.
* ``bucket_excess_tokens``: for each reserved tenant, the most prompt
  tokens its admissions took over any stretch of the scheduler's clock
  beyond what its bucket allows there (its depth, its rate times the
  stretch, and one refill), from the bucket registers the scheduler was
  given (their depth and refill) and the SLO the harness asked for (their
  rate), against the harness's log of each admission's time and size.
  Limit 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench import traffic, weights

#: a served token's gap, in units of the logits' spread, past which it
#: counts in ``gap_share``
GAP_TAU = 0.05
#: requests the sample holds at least, where the window finished that many
MIN_REQUESTS = 4


def sample(run) -> list:
    """Finished requests (by the window's end) to compare: the longest, then
    the rest in the seed's order while the reference's tokens stay within
    ``sample_tokens`` (at least ``MIN_REQUESTS`` of them where the window
    finished that many)."""
    p = run.cell.params["check"]
    done = sorted((r for r in run.log.recs.values()
                   if r.finished <= run.t1), key=lambda r: r.req.req_id)
    if not done:
        return []

    def cost(r):
        return len(r.req.prompt) + len(r.req.generated) - 1

    longest = max(done, key=cost)
    rest = [done[i] for i in traffic.rng(run.seed, "sample").permutation(
        len(done)) if done[i] is not longest]
    out, total = [longest], cost(longest)
    for r in rest:
        if total + cost(r) > p["sample_tokens"] and \
                len(out) >= MIN_REQUESTS:
            break
        out.append(r)
        total += cost(r)
    return out


def _sequences(recs, device):
    seqs, pos, served = [], [], []
    for r in recs:
        prompt = np.asarray(r.req.prompt, np.int64)
        gen = np.asarray(r.req.generated, np.int64)
        seqs.append(torch.as_tensor(np.concatenate([prompt, gen[:-1]]),
                                    device=device))
        pos.append(np.arange(len(prompt) - 1, len(prompt) - 1 + len(gen)))
        served.append(torch.as_tensor(gen, device=device))
    return seqs, pos, served


def logit_gaps(run, recs, device, *, control: bool = False,
               detail: bool = False) -> dict:
    """Each served token's gap below the float32 reference's best logit at
    its position, in units of the spread (standard deviation over the
    vocabulary) of the reference's logits there; read as ``gap_max``, the
    widest, and ``gap_share``, the share of tokens whose gap exceeds
    ``GAP_TAU``.  With ``control`` the same two of the tokens that
    the float8 reference puts first at those positions (``control_max``,
    ``control_share``).  ``detail`` adds each position's gaps and (a
    mixture of experts) the reference's routing margin there, as numpy
    arrays."""
    ref = run.cell.reference
    cfg = run.cfg
    w = weights.Weights(ref.param_specs(cfg), run.seed, device)
    seqs, pos, served = _sequences(recs, device)
    out = {"compared_tokens": int(sum(len(s) for s in served))}
    picks = None
    if control:
        picks = [lg.argmax(-1) for lg in ref.logits(cfg, w, seqs, pos,
                                                    fp8=True)]
    probe = {} if detail else None
    gaps, ctrl = [], []
    for i, lg in enumerate(ref.logits(cfg, w, seqs, pos, probe=probe)):
        best = lg.max(-1).values
        unit = lg.std(-1)
        gaps.append((best - lg.gather(-1, served[i][:, None])[:, 0]) / unit)
        if picks is not None:
            ctrl.append((best - lg.gather(-1, picks[i][:, None])[:, 0])
                        / unit)

    def read(parts, name):
        g = torch.cat(parts) if parts else torch.zeros(0)
        out[name + "_max"] = float(g.max()) if g.numel() else 0.0
        out[name + "_share"] = float((g > GAP_TAU).float().mean()) \
            if g.numel() else 0.0
        return g.cpu().numpy()

    d = {"gap": read(gaps, "gap")}
    if control:
        d["control"] = read(ctrl, "control")
    if detail:
        if "router_margin" in probe:
            starts = np.cumsum([0] + [len(s) for s in seqs[:-1]])
            rows = np.concatenate([p + s0 for p, s0 in zip(pos, starts)])
            d["margin"] = probe["router_margin"].cpu().numpy()[rows]
        out["detail"] = d
    return out


def token_count_errors(run) -> int:
    bad = 0
    for r in run.log.recs.values():
        n, want = len(r.req.generated), r.req.max_new_tokens
        if (r.finished <= run.t1 and n != want) or n > want:
            bad += 1
    return bad


def bucket_excess(run) -> float:
    """The largest excess, over every reserved tenant and every stretch
    [a, b] of its admissions, of the prompt tokens admitted over
    depth + rate * (t_b - t_a) + refill (negative: the slack left)."""
    b = run.buckets
    worst = -math.inf
    for i in range(len(b["slo"])):
        adm = sorted((r.admit_sched_s, len(r.req.prompt))
                     for r in run.log.recs.values()
                     if r.tenant == i and r.reserved
                     and not math.isnan(r.admit_sched_s))
        if not adm:
            continue
        # the SLO the tenant was given (the registers' integer refill and
        # interval approximate it within a part in a thousand)
        rate = b["slo"][i] * (1 + 1e-3)
        allow = b["depth"][i] + b["refill"][i]
        best_start, taken = -math.inf, 0
        for t, need in adm:
            best_start = max(best_start, rate * t - taken)
            taken += need
            worst = max(worst, taken - rate * t + best_start - allow)
    return worst if worst > -math.inf else 0.0


def checks(run, gaps: dict) -> dict:
    """{name: {"value", "limit"}} of every number compared: the gap numbers
    the cell file gives a limit for, and the accounting."""
    lim = run.cell.params["check"]
    out = {name: {"value": gaps[name], "limit": lim[name + "_limit"]}
           for name in ("gap_share", "gap_max") if name + "_limit" in lim}
    out["token_count_errors"] = {"value": token_count_errors(run),
                                 "limit": 0}
    out["bucket_excess_tokens"] = {"value": bucket_excess(run), "limit": 0}
    return out


def control_checks(run, gaps: dict) -> dict:
    """``checks`` with the float8 control's readings in the place of the
    program's: what the comparison would say of the control."""
    return checks(run, {"gap_max": gaps["control_max"],
                        "gap_share": gaps["control_share"]})


def passed(cks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in cks.values())

"""Whether the timed path served the right tokens.

Once the window has closed and the program's state is freed, a sample of
the served requests, drawn from the seed and holding the one with the
most served tokens, goes through the plain reference
(``reference/model.py``), teacher-forced on its prompt and served
tokens. At each position the gap is how far the served token's logit
lies below the reference's best. Two numbers are compared, each with its
own limit in the cell's ``check``:

* the worst request's median gap: the largest, over the sampled
  requests, of the median over that request's served tokens. It rises
  when a request is served wrong at most of its positions (a stale
  cache, a row left out, an altered token), whatever the others do;
* the worst request's mean gap, which also rises when a fault touches
  only a part of a request's positions (promotions that stop, a token
  altered now and then), where the median stays low.

The widest single gap is not compared: retrieval's candidate cut and
top-k are discontinuous in the keys, so bf16 rounding swaps winners and,
at a few positions of hundreds, moves the logits nearly as far as fp8
does (PERF.md gives the readings).

The control (``control_numbers``): the reference itself in fp8 (every
linear product's weight and input rounded to e4m3) takes the program's
place; at each position of the same prompts and tokens, the gap of the
token it ranks first. It has to fail a limit."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import model as RM


def sample(run, n: int) -> List:
    """``n`` of the requests with two or more served tokens, drawn from
    the seed, the one with the most tokens always in."""
    pool = [t for t in run.tracked if len(t.tokens) >= 2]
    if not pool:
        return []
    longest = max(pool, key=lambda t: (len(t.tokens), -t.index))
    rest = [t for t in pool if t is not longest]
    rng = np.random.default_rng([int(run.seed), 0xC4EC])
    pick = rng.permutation(len(rest))[:max(int(n) - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def _sequences(picked) -> List[RM.Sequence]:
    return [RM.Sequence(t.req.prompt, t.tokens) for t in picked]


def _reference_logits(run, seqs, precision: str):
    ref = RM.Reference(run.cfg, run.params, run.dev, precision)
    prefix = int(run.cell["traffic"].get("shared_prefix_tokens", 0))
    return ref.logits(seqs, run.cell["engine"]["args"]["n_max"],
                      prefix=prefix)


def served_gaps(run, picked) -> List[torch.Tensor]:
    """Each sampled request's gaps, one per served token: how far its
    logit lies below the reference's best."""
    seqs = _sequences(picked)
    return [RM.gaps(lg, s.served) for lg, s in
            zip(_reference_logits(run, seqs, "fp32"), seqs)]


def numbers(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, by the names the cell's limits use: the
    largest, over the sampled requests, of a request's median gap
    (torch's lower median) and of its mean gap."""
    return {"worst_request_median_gap": max(float(g.median()) for g in gaps),
            "worst_request_mean_gap": max(float(g.mean()) for g in gaps)}


def control_numbers(run, picked) -> Dict[str, Dict[str, float]]:
    """The program's and the fp8 control's readings on the same prompts
    and served tokens: the numbers compared, and the median and widest
    gap over every compared token (not compared)."""
    seqs = _sequences(picked)
    ref = _reference_logits(run, seqs, "fp32")
    ctl = _reference_logits(run, seqs, "fp8")
    out = {}
    for who, g in (("program", [RM.gaps(r, s.served)
                                for r, s in zip(ref, seqs)]),
                   ("control", [RM.gaps(r, c.argmax(-1))
                                for r, c in zip(ref, ctl)])):
        every = torch.cat(g)
        out[who] = dict(numbers(g), median=float(every.median()),
                        widest=float(every.max()))
    return out

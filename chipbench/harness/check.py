"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the run finished, the longest among
them, goes through the plain float32 reference: each prompt with the
token its prefill ended with and the tokens it served, in one pass. A
served token's gap is how far its reference logit lies below the
reference's best at that position; the number compared is the widest gap
of the sample (``max_gap``). Beside it, every finished request must have
served exactly its budget (``stream_len_errors``, limit 0).

The control puts the reference in the program's place one precision
below the configuration's bfloat16: every product through float8 (e4m3,
one scale per operand). At each position it reads the float32
reference's gap of the token the float8 pass puts first. Its numbers are
the program's, with that widest gap in ``max_gap``'s place under the
same limit, and go through the same ``passed``: a control that passes
means the limit cannot tell the two precisions apart.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from harness.stats import Record


def fp8_mm(a, b):
    """a @ b with each operand rounded through float8 e4m3 under one
    scale (its largest magnitude onto e4m3's largest, 448)."""
    import torch

    def q(x):
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    return q(a) @ q(b)


def sample(records: List[Record], seeds: Dict[int, int], k: int,
           seed: int) -> List[Record]:
    """Up to ``k`` finished requests drawn from the seed: the one that
    served the most tokens and k - 1 others."""
    done = [r for r in records if r.state == "completed"
            and r.rid in seeds and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (2 ** 64), 4]))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sequence(rec: Record, seed_tok: int) -> Tuple[np.ndarray, np.ndarray,
                                                 int]:
    """(the reference's input, the tokens the program produced at its
    last n + 1 positions, the prompt length)."""
    served = [seed_tok] + list(rec.tokens)
    seq = np.concatenate([np.asarray(rec.prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    return seq, np.asarray(served, np.int64), len(rec.prompt)


def gaps(ref, weights, cfg, rec: Record, seed_tok: int, device,
         control: bool = False) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The reference's gap of every token the program produced for
    ``rec``, and with ``control`` the gap of the float8 pass's choice."""
    import torch
    seq, served, p = sequence(rec, seed_tok)
    tokens = torch.from_numpy(seq).to(device)
    logits = ref.logits(weights, cfg, tokens)[p - 1:]
    best = logits.max(dim=-1).values
    picked = logits.gather(1, torch.from_numpy(served).to(device)[:, None])
    prog = (best - picked[:, 0]).cpu().numpy()
    ctrl = None
    if control:
        low = ref.logits(weights, cfg, tokens, mm=fp8_mm)[p - 1:]
        choice = low.argmax(dim=-1)
        ctrl = (best - logits.gather(1, choice[:, None])[:, 0]).cpu().numpy()
    return prog, ctrl


def stream_len_errors(records: List[Record]) -> int:
    return sum(1 for r in records
               if r.state == "completed" and len(r.tokens) != r.n_tokens)


def widest(run, control: bool = False) -> Tuple[float, float]:
    """The widest gap of the program's served tokens over the sample and,
    with ``control``, the widest of the float8 pass's choices (else 0).
    Nothing to check reads as the widest gap there is."""
    import torch
    cell = run.cell
    picked = sample(run.records, run.seeds, int(cell.serve["check"]["sample"]),
                    run.seed)
    ref = cell.reference()
    device = next(iter(_tensors(run.weights))).device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, ctrl_worst, n_tok = 0.0, 0.0, 0
    for rec in picked:
        prog, ctrl = gaps(ref, run.weights, cell.config, rec,
                          run.seeds[rec.rid], device, control)
        worst = max(worst, float(prog.max()))
        n_tok += len(prog)
        if ctrl is not None:
            ctrl_worst = max(ctrl_worst, float(ctrl.max()))
    if not n_tok:
        return 1e30, 1e30
    return worst, ctrl_worst


def numbers(run, gap: float,
            len_errors: int) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each with the cell's limit."""
    limits = run.cell.serve["check"]
    return {"max_gap": {"value": gap, "limit": limits.get("max_gap")},
            "stream_len_errors": {"value": len_errors, "limit": 0}}


def check(run) -> Dict[str, Dict[str, float]]:
    """The program's numbers, each with its limit."""
    gap, _ = widest(run)
    return numbers(run, gap, stream_len_errors(run.records))


def check_with_control(run) -> Tuple[Dict[str, Dict[str, float]],
                                     Dict[str, Dict[str, float]]]:
    """The program's numbers and the control's, from one pass of the
    reference. The control reads at each position of the served tokens,
    so it serves every budget exactly: it can fail on ``max_gap`` alone."""
    gap, ctrl_gap = widest(run, control=True)
    return (numbers(run, gap, stream_len_errors(run.records)),
            numbers(run, ctrl_gap, 0))


def passed(numbers: Dict[str, Dict[str, float]]) -> bool:
    """Every number at or under its limit (a limit not yet set fails)."""
    return all(n["limit"] is not None and n["value"] <= n["limit"]
               for n in numbers.values())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree

"""The check that decides ``correct``: what the window served, against the
plain float32 reference on the same weights and tokens.

Every number compared is a widest gap, held to a limit of its own (the
cell's ``limits``):

- ``token_gap`` (decode): over a sample of served tokens, the widest gap
  by which a served token's reference logit lies below the reference's
  best logit at that position.  0 where the program picked the
  reference's token.
- ``logit_err`` (prefill): over a sample of prefilled requests, the
  largest relative L2 gap ||program - reference|| / ||reference|| of the
  logits from which the request's first token was picked.  A prefill
  serves one token a request, and the few a check can afford do not
  separate the control from the program by their gap alone.
- ``state_err`` (prefill): over a sample of prefilled requests, the largest relative
  L2 gap ||program - reference|| / ||reference|| of one layer's decode
  state (the SSM state, the convolution's inputs, the keys and values at
  sampled positions) that the prefill hands on.
- ``state_err_first`` (prefill): the same, of the first layer of each
  kind alone (the first Mamba2 layer's SSM state and convolution inputs,
  the first attention's keys and values).  The gaps grow with depth as
  each layer's rounding adds to the stream; near the bottom (the first
  Mamba2 layer reads the embedding, equal on both sides) they hold the
  state's own path to the rounding of a few layers, so a fault there
  shows far above them even where ``state_err``'s deep layers would hide
  it.

The sample is drawn from the seed after the window: for a prefill pool the
longest request kept, then others in a seeded order up to
``sample["tokens"]`` prompt tokens; for a decode pool ``sample["rows"]``
requests, half from each half of the batch, every token they were served.
The reference runs after the program's state is freed, with TF32 off.

With ``control`` the same numbers are also read for the reference in
float8 (``bench.reference.quant``) put in the program's place (its own
logits and state for a prefill, its own pick at each position of the same
tokens for a decode) and judged by the same verdict; with ``witness`` (a
prefill) for the reference with its products' operands in bfloat16, the
precision the configurations state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import numpy as np
import torch

from bench import families, traffic, weights
from bench.reference.quant import bf16, fp8


@dataclasses.dataclass
class Kept:
    """A prefilled request whose output the run kept for the check."""
    batch: traffic.Batch
    row: int
    logits: torch.Tensor        # (V,) whence its first token was picked
    state: dict                 # {leaf: (layers, ...)} on the host
    picks: dict                 # {leaf: what of its axis 1 was kept}


def reference(cfg: dict):
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


@contextlib.contextmanager
def full_float32():
    """Float32 products in full float32 (TF32 off) while the reference
    runs."""
    m = torch.backends.cuda.matmul.allow_tf32
    d = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = d


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits (..., V), tokens (...): best logit less the token's."""
    tokens = tokens.to(logits.device).long()
    return logits.max(dim=-1).values - logits.gather(
        -1, tokens[..., None])[..., 0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float32 (NaN where got has one)."""
    got = got.to(device=want.device, dtype=torch.float32)
    den = torch.linalg.vector_norm(want).item()
    return torch.linalg.vector_norm(got - want).item() / max(den, 1e-30)


def layer_errs(state: dict, ref: dict, device) -> dict[str, list[float]]:
    """Each leaf of ``state``'s relative L2 gap to ``ref``, layer by layer
    (or application by application of a shared block)."""
    out = {}
    for leaf, got in state.items():
        want = ref[leaf]
        got = got.to(device=device, dtype=torch.float32)
        out[leaf] = [rel_err(got[i], want[i]) for i in range(want.shape[0])]
    return out


def worst(by_layer: dict) -> tuple[float, str]:
    """The largest gap of ``layer_errs``' output, and the leaf and layer
    where it is (NaN counts as the largest)."""
    top, where = 0.0, ""
    for leaf, errs in by_layer.items():
        for i, err in enumerate(errs):
            if not err <= top:
                top, where = err, f"{leaf}[{i}]"
    return top, where


def state_err(state: dict, ref: dict, device) -> tuple[float, str]:
    """The largest per-layer relative L2 gap over the leaves of ``state``
    and the leaf and layer where it is."""
    return worst(layer_errs(state, ref, device))


def select(kept: list[Kept], seed: int, budget: int) -> list[Kept]:
    """The longest kept request, one kept from the second half of a batch
    of two or more (where a fault that serves half a batch shows), then
    others, in a seeded order while their prompt tokens stay within
    ``budget``."""
    if not kept:
        return []
    longest = max(range(len(kept)), key=lambda i: (kept[i].batch.length, -i))
    rng = np.random.default_rng(traffic.subseed(seed, traffic.STREAM_SAMPLE,
                                                1 << 41))
    order = [int(i) for i in rng.permutation(len(kept))]
    second = [i for i in order
              if kept[i].row >= kept[i].batch.batch // 2 > 0]
    chosen, total = [longest], kept[longest].batch.length
    for i in second[:1] + order:
        length = kept[i].batch.length
        if i not in chosen and total + length <= budget:
            chosen.append(i)
            total += length
    return [kept[i] for i in sorted(chosen)]


def passes(c, values: dict) -> bool:
    """The verdict: every number the cell compares is there and within
    its limit."""
    return all(name in values and values[name] <= limit
               for name, limit in c.limits.items())


def _verdict(c, values: dict, control: dict | None, extra: dict) -> dict:
    return {"correct": bool(passes(c, values)), "values": values,
            "limits": dict(c.limits), "control": control,
            "control_correct": (None if control is None
                                else bool(passes(c, control))),
            **extra}


def _picked(out: dict, picks: dict, cut) -> dict:
    """A reference prefill's state with each leaf of ``cut`` that a run
    picked from cut to its picks (the SSM heads a run kept; the reference
    hands the keys and values back at the kept positions already)."""
    for leaf in cut:
        if leaf in picks:
            out[leaf] = out[leaf].index_select(1, picks[leaf].to(
                out[leaf].device))
    return out


class _Prefills:
    """The prefill numbers of one side (the program, the control or the
    witness) over the requests of a check."""

    def __init__(self):
        self.logit, self.layers = [], []

    def add(self, logits, state: dict, want: dict, device) -> dict:
        self.logit.append(rel_err(logits, want["logits"]))
        self.layers.append(layer_errs(state, want, device))
        return self.layers[-1]

    def values(self) -> dict:
        nan = float("nan")
        return {"logit_err": max(self.logit, default=nan),
                "state_err": max((worst(b)[0] for b in self.layers),
                                 default=nan),
                "state_err_first": max((worst({k: v[:1] for k, v in
                                               b.items()})[0]
                                        for b in self.layers), default=nan)}

    def by_layer(self) -> dict:
        """Each leaf's largest gap over the requests, layer by layer."""
        if not self.layers:
            return {}
        return {leaf: [max(b[leaf][i] for b in self.layers)
                       for i in range(len(self.layers[0][leaf]))]
                for leaf in self.layers[0]}


def check_prefill(c, seed: int, kept: list[Kept], device,
                  control: bool = False, witness: bool = False) -> dict:
    t0 = time.perf_counter()
    cfg = c.cfg
    ref, fam = reference(cfg), families.of(cfg)
    sample = select(kept, seed, c.sample["tokens"])
    W = weights.make(cfg, traffic.subseed(seed, traffic.STREAM_WEIGHTS),
                     device)
    lower = {}
    if control:
        lower["control"] = fp8
    if witness:
        lower["witness"] = bf16
    sides = {side: _Prefills() for side in ("program", *lower)}
    top, where = -1.0, ""
    with torch.no_grad(), full_float32():
        for k in sample:
            tokens = traffic.prompts(k.batch, cfg["vocab_size"], seed,
                                     device)[k.row]
            pos = k.picks[fam.POSITIONS].to(device)
            want = _picked(ref.prefill(W, cfg, tokens, pos), k.picks,
                           fam.CUT)
            err, leaf = worst(sides["program"].add(k.logits, k.state, want,
                                                   device))
            if not err <= top:
                top, where = err, (f"row {k.row} of batch {k.batch.index} "
                                   f"({k.batch.batch} x {k.batch.length}): "
                                   f"{leaf}")
            for side, quant in lower.items():
                low = _picked(ref.prefill(W, cfg, tokens, pos, quant=quant),
                              k.picks, fam.CUT)
                sides[side].add(
                    low["logits"], {leaf: low[leaf] for leaf in k.state},
                    want, device)
                del low
            del want
    values = sides["program"].values()
    ctl = sides["control"].values() if control else None
    return _verdict(c, values, ctl, {
        "requests": len(sample),
        "tokens": sum(k.batch.length for k in sample),
        "worst_state": where, "seconds": time.perf_counter() - t0,
        "witness": sides["witness"].values() if witness else None,
        "by_layer": {side: r.by_layer() for side, r in sides.items()}})


def decode_rows(B: int, n: int, seed: int, index: int) -> list[int]:
    """``n`` requests of a batch of B, half from each half."""
    rng = np.random.default_rng(traffic.subseed(seed, traffic.STREAM_SAMPLE,
                                                (1 << 42) + index))
    half = B // 2
    if half == 0:
        return list(range(B))
    lo = rng.choice(half, size=min(n // 2, half), replace=False)
    hi = half + rng.choice(B - half, size=min(n - n // 2, B - half),
                           replace=False)
    return sorted(int(r) for r in np.concatenate([lo, hi]))


def check_decode(c, seed: int, histories: list, device,
                 control: bool = False) -> dict:
    """``histories``: (batch, its generated tokens (B, n) on the host) for
    every batch the run decoded."""
    t0 = time.perf_counter()
    cfg = c.cfg
    ref = reference(cfg)
    W = weights.make(cfg, traffic.subseed(seed, traffic.STREAM_WEIGHTS),
                     device)
    gaps, c_gaps, n_tokens = [], [], 0
    with torch.no_grad(), full_float32():
        for b, hist in histories:
            prompts = traffic.prompts(b, cfg["vocab_size"], seed, device)
            for row in decode_rows(b.batch, c.sample["rows"], seed, b.index):
                served = hist[row].to(device)
                seq = torch.cat([prompts[row], served[:-1]])
                want = ref.logits_from(W, cfg, seq, b.length - 1)
                gaps.append(gap(want, served).max().item())
                n_tokens += served.numel()
                if control:
                    low = ref.logits_from(W, cfg, seq, b.length - 1,
                                          quant=fp8)
                    c_gaps.append(gap(want, low.argmax(-1)).max().item())
                del want
    values = {"token_gap": max(gaps, default=float("nan"))}
    ctl = ({"token_gap": max(c_gaps, default=float("nan"))} if control
           else None)
    return _verdict(c, values, ctl, {
        "requests": len(gaps), "tokens": n_tokens,
        "seconds": time.perf_counter() - t0})

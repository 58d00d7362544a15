"""Known-contender accounting and external load intensity (Sec. 3.1.3).

The five contender classes around a transfer t_p (same src+dst, source
outgoing/incoming, destination outgoing/incoming) are explained away using
their logged aggregate rates (Assumption 1: TCP gives competing streams an
aggregate fair share).  What remains unexplained is attributed to uncharted
traffic via the load-intensity heuristic of Eq. 20: I_s = (bw - th_out)/bw.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim.loggen import LogEntry


@dataclasses.dataclass(frozen=True)
class ContenderSummary:
    r_same: float
    r_src_out: float
    r_src_in: float
    r_dst_out: float
    r_dst_in: float

    @property
    def total_competing(self) -> float:
        """Rates that share the forward path of t_p (src->dst direction)."""
        return self.r_same + self.r_src_out + self.r_dst_in


def summarize_contenders(entry: LogEntry) -> ContenderSummary:
    return ContenderSummary(entry.r_same, entry.r_src_out, entry.r_src_in,
                            entry.r_dst_out, entry.r_dst_in)


def load_intensity(entry: LogEntry) -> float:
    """External (uncharted) load intensity I_s = (bw - th_out)/bw (Eq. 20).

    ``th_out`` is the total charted outgoing rate: the transfer's own achieved
    throughput plus known contenders on the same path.  The residual headroom
    is attributed to uncharted traffic and protocol inefficiency; binning
    entries by I_s groups observations taken under similar external loads.
    """
    th_out = entry.throughput_mbps + summarize_contenders(entry).total_competing
    return float(np.clip((entry.bandwidth_mbps - th_out) / entry.bandwidth_mbps,
                         0.0, 1.0))


def intensity_bins(entries: list[LogEntry], n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """Quantile-bin entries by I_s -> (bin_index per entry, bin centers)."""
    I = np.array([load_intensity(e) for e in entries])
    qs = np.quantile(I, np.linspace(0.0, 1.0, n_bins + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    idx = np.clip(np.searchsorted(qs, I, side="right") - 1, 0, n_bins - 1)
    centers = np.array([I[idx == b].mean() if (idx == b).any() else np.nan
                        for b in range(n_bins)])
    return idx, centers


def residual_intensity_bins(entries: list[LogEntry], n_bins: int,
                            base_surface) -> tuple[np.ndarray, np.ndarray]:
    """Bin entries by external load after explaining away parameter effects.

    Eq. 20's raw I_s conflates "bad parameters" with "heavy load": a transfer
    run with cc=p=pp=1 reads as heavy load even on an idle link.  Assumption 2
    says the residual fluctuation *after explaining away known effects* is
    what tracks external load — so we explain away the protocol-parameter
    effect with a load-agnostic cluster base surface f0 and score each entry
    by the ratio th / f0(theta).  High ratio = lighter-than-average load.
    Returned bin centers are monotone load tags in [0, 1] (low = light).
    """
    pts = np.array([[e.p, e.cc, e.pp] for e in entries], np.float64)
    th = np.array([e.throughput_mbps for e in entries], np.float64)
    base = np.maximum(base_surface.batch_eval(pts), 1e-6)
    ratio = th / base
    qs = np.quantile(ratio, np.linspace(0.0, 1.0, n_bins + 1))
    qs[0], qs[-1] = -np.inf, np.inf
    idx = np.clip(np.searchsorted(qs, ratio, side="right") - 1, 0, n_bins - 1)
    # high ratio -> light load -> low tag; tags stay ordered and in [0, 1]
    centers = np.empty(n_bins)
    for b in range(n_bins):
        r = float(np.median(ratio[idx == b])) if (idx == b).any() else 1.0
        centers[b] = 1.0 - min(r, 1.6) / 1.6
    # bin index b is by ascending ratio = descending load tag; flip so that
    # bin 0 = lightest for readability
    return idx, centers

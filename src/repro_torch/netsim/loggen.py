"""Synthetic historical transfer logs in the Globus-log schema the paper mines.

Each entry records the tuple the offline phase needs: endpoints, link metrics,
dataset characteristics, protocol parameters, achieved throughput, timestamp,
and the aggregate rates of the five known-contender classes (Sec. 3.1.3).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim.environment import Environment, ParamBounds, TransferParams
from repro_torch.netsim.workload import FILE_CLASSES, make_dataset


def features_of(bandwidth_mbps: float, rtt_s: float, avg_file_mb: float,
                n_files: float) -> np.ndarray:
    """The canonical clustering feature vector (log link + dataset facts).

    Shared by ``LogEntry.features()``, request-side lookups, and the
    cross-network cold-start similarity ranking, so a network with no
    history can still be placed in the same feature space its donors were
    clustered in."""
    return np.array([
        np.log10(bandwidth_mbps),
        np.log10(max(rtt_s, 1e-5)),
        np.log10(avg_file_mb),
        np.log10(n_files),
    ])


@dataclasses.dataclass(frozen=True)
class LogEntry:
    src: str
    dst: str
    bandwidth_mbps: float
    rtt_s: float
    avg_file_mb: float
    n_files: int
    cc: int
    p: int
    pp: int
    throughput_mbps: float
    timestamp_s: float
    ext_load: float            # latent; exposed only for oracle evaluation
    # aggregate rates of known contending transfers (Sec. 3.1.3 classes)
    r_same: float = 0.0        # same src+dst
    r_src_out: float = 0.0
    r_src_in: float = 0.0
    r_dst_out: float = 0.0
    r_dst_in: float = 0.0

    @property
    def contending_mbps(self) -> float:
        return self.r_same + self.r_src_out + self.r_dst_in

    def features(self) -> np.ndarray:
        """Clustering feature vector: link + dataset characteristics."""
        return features_of(self.bandwidth_mbps, self.rtt_s,
                           self.avg_file_mb, self.n_files)


def generate_history(env: Environment, *, days: float = 14.0,
                     transfers_per_day: int = 220, seed: int = 0,
                     bounds: ParamBounds = ParamBounds(),
                     src: str = "src", dst: str = "dst") -> list[LogEntry]:
    """Replay `days` of user transfers with assorted parameters over the
    environment's diurnal load, recording what a Globus-style log would hold."""
    rng = np.random.default_rng(seed)
    entries: list[LogEntry] = []
    day_s = 24 * 3600.0
    n_total = int(days * transfers_per_day)
    # Users favour round/popular parameter values; logs are not a uniform grid.
    popular = np.array([1, 2, 4, 8, 16])
    for i in range(n_total):
        t = rng.uniform(0.0, days * day_s)
        env.clock_s = t
        fclass = rng.choice(list(FILE_CLASSES))
        ds = make_dataset(fclass, rng)
        if rng.random() < 0.7:
            prm = TransferParams(int(rng.choice(popular)),
                                 int(rng.choice(popular)),
                                 int(rng.choice(popular)))
        else:
            prm = TransferParams(int(rng.integers(1, bounds.max_cc + 1)),
                                 int(rng.integers(1, bounds.max_p + 1)),
                                 int(rng.integers(1, bounds.max_pp + 1)))
        prm = prm.clip(bounds)
        load = env.current_load()
        # Known contenders: occasionally other logged transfers share the path.
        r_same = float(rng.exponential(0.03) * env.link.bandwidth_mbps
                       ) if rng.random() < 0.15 else 0.0
        r_src_out = float(rng.exponential(0.02) * env.link.bandwidth_mbps
                          ) if rng.random() < 0.10 else 0.0
        r_dst_in = float(rng.exponential(0.02) * env.link.bandwidth_mbps
                         ) if rng.random() < 0.10 else 0.0
        th = env.mean_throughput(prm, ds.avg_file_mb, ds.n_files, load,
                                 contending_mbps=r_same + r_src_out + r_dst_in)
        th *= float(1.0 + rng.normal(0.0, env.noise_sigma))
        entries.append(LogEntry(
            src=src, dst=dst,
            bandwidth_mbps=env.link.bandwidth_mbps, rtt_s=env.link.rtt_s,
            avg_file_mb=ds.avg_file_mb, n_files=ds.n_files,
            cc=prm.cc, p=prm.p, pp=prm.pp,
            throughput_mbps=max(th, 0.0), timestamp_s=t, ext_load=load,
            r_same=r_same, r_src_out=r_src_out, r_dst_in=r_dst_in,
        ))
    entries.sort(key=lambda e: e.timestamp_s)
    return entries


def generate_multi_network_history(names: list[str] | None = None, *,
                                   days: float = 14.0,
                                   transfers_per_day: int = 220,
                                   seed: int = 0,
                                   bounds: ParamBounds = ParamBounds()
                                   ) -> list[LogEntry]:
    """Replay history over several testbeds into one merged Globus-style log.

    Each named testbed (default: all of ``netsim.testbeds.TESTBEDS``) is an
    endpoint pair ``<name>/a -> <name>/b`` with its own diurnal traffic and
    RNG stream, so the merged log is what a fleet-wide log store would hold
    and ``MultiNetworkDB.fit`` can group it back per network."""
    from repro_torch.netsim.testbeds import TESTBEDS, make_testbed
    if names is None:
        names = list(TESTBEDS)
    entries: list[LogEntry] = []
    for i, name in enumerate(names):
        env = make_testbed(name, seed=seed + 101 * i)
        entries.extend(generate_history(
            env, days=days, transfers_per_day=transfers_per_day,
            seed=seed + 13 * i, bounds=bounds,
            src=f"{name}/a", dst=f"{name}/b"))
    entries.sort(key=lambda e: e.timestamp_s)
    return entries


def sample_feature_logs(n: int, *, seed: int = 0,
                        names: list[str] | None = None) -> np.ndarray:
    """Feature-space-only history sampler for scale benchmarks.

    Draws the clustering feature vectors of ``n`` log rows spread across
    the named testbeds — the same marginal distribution ``generate_history``
    produces (per-testbed link facts, log-uniform file sizes inside the
    paper's three file classes) — fully vectorized, so million-row feature
    matrices materialize in milliseconds instead of simulating a million
    transfers.  Returns an ``(n, 4)`` float array."""
    from repro_torch.netsim.testbeds import TESTBEDS
    if names is None:
        names = list(TESTBEDS)
    rng = np.random.default_rng(seed)
    bw = np.array([TESTBEDS[nm].bandwidth_mbps for nm in names])
    rtt = np.array([TESTBEDS[nm].rtt_s for nm in names])
    net = rng.integers(0, len(names), n)
    classes = list(FILE_CLASSES.values())
    lo = np.array([c[0] for c in classes])
    hi = np.array([c[1] for c in classes])
    n_lo = np.array([c[2] for c in classes])
    n_hi = np.array([c[3] for c in classes])
    fc = rng.integers(0, len(classes), n)
    avg = np.exp(rng.uniform(np.log(lo[fc]), np.log(hi[fc])))
    n_files = rng.integers(n_lo[fc], n_hi[fc] + 1)
    return np.stack([
        np.log10(bw[net]),
        np.log10(np.maximum(rtt[net], 1e-5)),
        np.log10(avg),
        np.log10(n_files),
    ], axis=1)

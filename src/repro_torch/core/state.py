"""Plain-data state of an ``OfflineDB``, to carry fitted knowledge across.

``offline_db_to_state`` reads an ``OfflineDB`` by attribute only, so it takes
the DB of either package (this one or the JAX package it was ported from)
without importing the other; ``offline_db_from_state`` builds this package's
``OfflineDB`` from the result.  The state holds numpy arrays, numbers,
strings and tuples only: the cluster model, every cluster's surfaces
(grids, spline coefficients, confidence band, precomputed maxima), sampling
region and raw entry store, and the DB's bounds and load-bin count.  A DB
that went through both functions answers every online query exactly as the
original does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.clustering import ClusterModel
from repro_torch.core.maxima import LocalMax
from repro_torch.core.offline import ClusterKnowledge, OfflineDB
from repro_torch.core.regions import SamplingRegion
from repro_torch.core.spline import TricubicSurface
from repro_torch.core.surfaces import ThroughputSurface
from repro_torch.device import resolve_device
from repro_torch.netsim.environment import ParamBounds, TransferParams
from repro_torch.netsim.loggen import LogEntry


def _array(a):
    return None if a is None else np.array(a)


def _params(prm) -> tuple[int, int, int]:
    return (int(prm.cc), int(prm.p), int(prm.pp))


def _surface_state(ts) -> dict:
    s = ts.surface
    return {
        "gp": np.array(s.gp), "gcc": np.array(s.gcc), "gpp": np.array(s.gpp),
        "grid": np.array(s.grid), "ppc": np.array(s.ppc),
        "sigma": float(ts.sigma),
        "load_intensity": float(ts.load_intensity),
        "argmax_params": _params(ts.argmax_params),
        "max_throughput": float(ts.max_throughput),
        "local_maxima": [(_params(lm.params), float(lm.value), bool(lm.interior))
                         for lm in ts.local_maxima],
        "n_obs": int(ts.n_obs),
    }


def _region_state(r) -> dict:
    return {
        "maxima_points": [_params(p) for p in r.maxima_points],
        "radius": float(r.radius),
        "discriminative_points": [_params(p) for p in r.discriminative_points],
        "separations": [float(v) for v in r.separations],
    }


def offline_db_to_state(db) -> dict:
    """Everything an ``OfflineDB`` of either package knows, as plain data."""
    cm = db.cluster_model
    return {
        "cluster_model": {
            "centroids": np.array(cm.centroids), "labels": _array(cm.labels),
            "counts": _array(cm.counts), "m": int(cm.m),
            "method": str(cm.method), "ch": float(cm.ch),
        },
        "clusters": [{
            "centroid": np.array(ck.centroid),
            "surfaces": [_surface_state(ts) for ts in ck.surfaces],
            "region": _region_state(ck.region),
            "region_seed": int(ck.region_seed),
            "entries": [dataclasses.astuple(e) for e in ck.entries],
        } for ck in db.clusters],
        "bounds": (int(db.bounds.max_cc), int(db.bounds.max_p),
                   int(db.bounds.max_pp)),
        "n_load_bins": int(db.n_load_bins),
        "fit_seconds": float(db.fit_seconds),
        "origin": None if db.origin is None else tuple(db.origin),
    }


def _surface(st: dict) -> ThroughputSurface:
    surf = TricubicSurface(np.array(st["gp"]), np.array(st["gcc"]),
                           np.array(st["gpp"]), np.array(st["grid"]),
                           np.array(st["ppc"]))
    return ThroughputSurface(
        surface=surf, sigma=st["sigma"], load_intensity=st["load_intensity"],
        argmax_params=TransferParams(*st["argmax_params"]),
        max_throughput=st["max_throughput"],
        local_maxima=[LocalMax(TransferParams(*p), v, i)
                      for p, v, i in st["local_maxima"]],
        n_obs=st["n_obs"])


def _region(st: dict) -> SamplingRegion:
    return SamplingRegion(
        [TransferParams(*p) for p in st["maxima_points"]], st["radius"],
        [TransferParams(*p) for p in st["discriminative_points"]],
        list(st["separations"]))


def offline_db_from_state(state: dict, device=None) -> OfflineDB:
    """This package's ``OfflineDB`` from :func:`offline_db_to_state`'s dict;
    later refits run on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    cm = state["cluster_model"]
    model = ClusterModel(_array(cm["labels"]), np.array(cm["centroids"]),
                         cm["m"], cm["method"], cm["ch"],
                         counts=_array(cm["counts"]))
    clusters = [ClusterKnowledge(
        np.array(ck["centroid"]), [_surface(s) for s in ck["surfaces"]],
        _region(ck["region"]), [LogEntry(*e) for e in ck["entries"]],
        region_seed=ck["region_seed"], device=device)
        for ck in state["clusters"]]
    return OfflineDB(clusters, model, ParamBounds(*state["bounds"]),
                     state["n_load_bins"], state["fit_seconds"],
                     origin=state["origin"], device=device)

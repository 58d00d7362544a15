"""The port's copy of the simulator gives the JAX package's outputs bit for
bit: the same logs and feature matrices for the same seeds, and the same
transfer results from the same environments, faulted or not."""
import numpy as np
import pytest

import repro.netsim as jn
import repro_torch.netsim as pn
from _port_parity import assert_same, plain

PARAMS = [(4, 4, 4), (1, 1, 1), (16, 8, 2), (8, 16, 16), (2, 3, 9)]


def test_generate_history_is_equal():
    a = jn.generate_history(jn.make_testbed("xsede", seed=3), days=2,
                            transfers_per_day=80, seed=5)
    b = pn.generate_history(pn.make_testbed("xsede", seed=3), days=2,
                            transfers_per_day=80, seed=5)
    assert len(a) == len(b) > 100
    assert_same(a, b)


def test_generate_multi_network_history_is_equal():
    a = jn.generate_multi_network_history(days=1.0, transfers_per_day=60,
                                          seed=2)
    b = pn.generate_multi_network_history(days=1.0, transfers_per_day=60,
                                          seed=2)
    assert len({(e.src, e.dst) for e in b}) == 3
    assert_same(a, b)


@pytest.mark.parametrize("n,seed", [(1, 0), (5000, 7), (20000, 3)])
def test_sample_feature_logs_is_equal(n, seed):
    a = jn.sample_feature_logs(n, seed=seed)
    b = pn.sample_feature_logs(n, seed=seed)
    assert b.shape == (n, 4)
    np.testing.assert_array_equal(a, b)


def _transfers(nm, name, faults=None, kill_ok=False):
    env = nm.make_testbed(name, seed=9)
    env.clock_s = 4 * 3600.0
    if faults is not None:
        env.faults = faults(nm, env.clock_s)
    out = []
    for cc, p, pp in PARAMS * 3:
        try:
            out.append(env.transfer(nm.TransferParams(cc, p, pp), 900.0,
                                    100.0, 50))
        except nm.SessionKilled as kill:
            assert kill_ok
            out.append(("killed", kill.moved_mb, kill.at_s))
        out.append(env.clock_s)
    return out


@pytest.mark.parametrize("name", ["xsede", "didclab", "didclab-xsede"])
def test_environment_transfers_are_bit_equal(name):
    assert_same(_transfers(jn, name), _transfers(pn, name))


def _schedule(nm, t0):
    return nm.FaultSchedule((
        nm.CapacityDrop(t0 + 5.0, 40.0, factor=0.3),
        nm.LinkFlap(t0 + 60.0, 20.0, residual=0.05),
        nm.LossBurst(t0 + 100.0, 30.0, loss_sensitivity_mult=4.0,
                     streams_to_saturate_mult=2.0, goodput_factor=0.5),
        nm.TenantKill(t0 + 150.0),
    ))


def _generated(nm, t0):
    return nm.FaultSchedule.generate(11, start_s=t0, horizon_s=300.0,
                                     n_flaps=2, n_drops=2, n_bursts=1,
                                     n_kills=1)


@pytest.mark.parametrize("faults,killed", [(_schedule, True),
                                           (_generated, False)])
def test_faulted_transfers_are_bit_equal(faults, killed):
    a = _transfers(jn, "xsede", faults, kill_ok=True)
    b = _transfers(pn, "xsede", faults, kill_ok=True)
    assert any(isinstance(r, tuple) for r in b) == killed
    assert plain(a) == plain(b)
    assert plain(b) != plain(_transfers(pn, "xsede"))  # the faults bit

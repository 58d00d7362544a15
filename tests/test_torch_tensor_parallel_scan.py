"""The model-axis split of the scan families (zamba2-7b's Mamba2 layers
and shared block, rwkv6-1.6b's time and channel mix) against the JAX
package's unsplit results, on the CPU, as ``test_torch_tensor_parallel``
holds the dense families (its references and bounds, computed in this
process): gloo groups of 2 ranks (1, 2) and 4 ranks (2, 2) and (2, 1, 2)
hold the forward, the loss, every gathered gradient, three sharded steps
and prefill with 4 greedy decode steps.  With ``reduce_from`` (identity
backward) in place of the gated norm's ``sum_partial``, the gradient of
``norm_w`` must leave the reference's bound."""
import pytest

import _dist_workers
from test_torch_tensor_parallel import (GROUP_TIMEOUT_S, SCAN_CONFIGS,
                                        _reference, _write_case)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", SCAN_CONFIGS)
def test_split_matches_reference(tmp_path, name, world):
    """The split model against the reference's unsplit results on every
    mesh of ``_dist_workers.TP_MESHES[world]``."""
    _write_case(tmp_path, _reference(name))
    _dist_workers.spawn_group(tmp_path, world, ["tp_parity"],
                              GROUP_TIMEOUT_S)


def test_norm_sum_needs_its_backward_all_reduce(tmp_path):
    """zamba2-7b's smoke config split over 2 ranks: with ``reduce_from``
    (identity backward) in place of the gated norm's ``sum_partial``, the
    forward is unchanged but the gradient of ``norm_w`` leaves the
    reference's bound, which the right collective meets."""
    _write_case(tmp_path, _reference("zamba2-7b"))
    _dist_workers.spawn_group(tmp_path, 2, ["tp_norm_backward"],
                              GROUP_TIMEOUT_S)

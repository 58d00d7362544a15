"""Testbed parameterizations from Table 1 of the paper.

  * XSEDE  : Stampede (TACC) <-> Gordon (SDSC).  10 Gbps, 40 ms RTT, 48 MB TCP
             buffers, 1200 MB/s (9600 Mbps) disks.
  * DIDCLAB: WS-10 <-> Evenstar on the lab LAN.   1 Gbps, 0.2 ms RTT, 10 MB
             buffers, 90 MB/s (720 Mbps) disks — disk-bound, as Sec. 4.2 notes.
  * DIDCLAB_XSEDE: lab to Gordon over the Internet — 1 Gbps last mile, high and
             variable RTT, unpredictable peak (Sec. 4.3).
"""
from __future__ import annotations

from repro_torch.netsim.environment import Environment, LinkSpec
from repro_torch.netsim.traffic import DiurnalTraffic

XSEDE = LinkSpec(
    name="xsede",
    bandwidth_mbps=10_000.0,
    rtt_s=0.040,
    tcp_buffer_mb=48.0,
    disk_read_mbps=9_600.0,
    disk_write_mbps=9_600.0,
    cores=16,
    streams_to_saturate=20,
)

DIDCLAB = LinkSpec(
    name="didclab",
    bandwidth_mbps=1_000.0,
    rtt_s=0.0002,
    tcp_buffer_mb=10.0,
    disk_read_mbps=720.0,
    disk_write_mbps=720.0,
    cores=8,
    streams_to_saturate=2,
)

DIDCLAB_XSEDE = LinkSpec(
    name="didclab-xsede",
    bandwidth_mbps=1_000.0,
    rtt_s=0.055,
    tcp_buffer_mb=10.0,
    disk_read_mbps=720.0,
    disk_write_mbps=9_600.0,
    cores=8,
    congestion_knee=0.75,
    loss_sensitivity=3.0,
    streams_to_saturate=10,
)

TESTBEDS: dict[str, LinkSpec] = {
    "xsede": XSEDE,
    "didclab": DIDCLAB,
    "didclab-xsede": DIDCLAB_XSEDE,
}

_TRAFFIC = {
    # WAN backbone: broad afternoon peak.
    "xsede": dict(base_load=0.08, peak_load=0.45, peak_hour=14.0, peak_width_h=5.0),
    # University LAN: sharp 11am-3pm peak (Sec. 4.2).
    "didclab": dict(base_load=0.05, peak_load=0.60, peak_hour=13.0, peak_width_h=2.0),
    # Commodity Internet: unpredictable, heavier jitter (Sec. 4.3).
    "didclab-xsede": dict(base_load=0.12, peak_load=0.50, peak_hour=15.0,
                          peak_width_h=6.0, jitter=0.08),
}


def make_traffic(name: str, *, seed: int = 0,
                 constant_load: float | None = None) -> DiurnalTraffic:
    """The testbed's traffic process alone, no :class:`Environment`.

    For engines that construct their own tenant environments and would
    otherwise build (and throw away) a whole base environment just to read
    its traffic model off ``make_testbed``.
    """
    if constant_load is not None:
        return DiurnalTraffic.constant(constant_load)
    return DiurnalTraffic(seed=seed + 17, **_TRAFFIC[name])


def make_testbed(name: str, *, seed: int = 0,
                 constant_load: float | None = None) -> Environment:
    link = TESTBEDS[name]
    traffic = make_traffic(name, seed=seed, constant_load=constant_load)
    return Environment(link, traffic, seed=seed)

"""Calibrated testbed models.

ANL_UC reproduces the paper's Table 1 testbed (TG_ANL_IA32/IA64 + GPFS with
8 I/O servers + UC_x64 dispatcher host).  Calibration is anchored on the
paper's own measured envelope (§4.2, Figures 3-5):

  * GPFS aggregate read tops out at 3.4 Gb/s  -> store_read = 425 MB/s
  * GPFS read+write tops out at 1.1 Gb/s      -> store_write = 68.75 MB/s
    (mixed workload saturates writes first: 2 * 68.75 MB/s = 1.1 Gb/s moved)
  * Figure 3 ideal at 64 nodes = 65.6 Gb/s    -> disk_read = 128 MB/s/node
  * Figure 4 ideal at 64 nodes = 23.6 Gb/s    -> disk_write = 28 MB/s/node
    (2 / (1/128 + 1/28) ~= 46 MB/s moved per node * 64 ~= 23.6 Gb/s)
  * per-node GigE                              -> nic = 125 MB/s each way
  * data-unaware 100%-locality read = 5.7 Gb/s at 64 nodes (Fig 3)
    -> per-flow GridFTP cap ~= 18 MB/s + 50 ms session setup (the fetched
       copy is also written through to the local disk cache, serialized)
  * config-8 efficiency ~94% of ideal -> per-task executor overhead 50 ms
    (Falkon executor launch + JVM + notification round-trip)
  * wrapper floor ~21 tasks/s on 64 nodes with 3 metadata ops/task (Fig 5)
    -> GPFS metadata op latency ~= 15 ms serialized (=> ~22 tasks/s)
  * dispatcher: 3800 tasks/s non-data-aware (§3.2.3) -> 0.26 ms service;
    data-aware adds ~2 us/lookup (hash-table scale, §3.2.3), budget 2.1 ms.
  * UC_x64 <-> cluster latency 1-2 ms (Table 1)  -> 1.5 ms dispatch RTT.
"""
from __future__ import annotations

from dataclasses import dataclass

MB = 1e6
GB = 1e9
Gbps = 1e9 / 8.0


@dataclass(frozen=True)
class TestbedSpec:
    name: str
    # persistent store
    store_read_bw: float            # aggregate bytes/s
    store_write_bw: float
    store_meta_latency_s: float     # serialized metadata op
    store_open_latency_s: float     # per-file open on the store path
    # per node
    disk_read_bw: float
    disk_write_bw: float
    nic_in_bw: float
    nic_out_bw: float
    local_open_latency_s: float
    # peer (GridFTP-analogue) transport
    peer_flow_cap: float            # single-stream cap, bytes/s
    peer_setup_latency_s: float
    # dispatcher
    dispatch_service_s: float       # non-data-aware per-task service
    index_lookup_s: float           # per-lookup add-on when data-aware
    dispatch_rtt_s: float           # service<->executor one-way latency
    # per-task executor-side overhead (launch + notify)
    task_overhead_s: float = 0.0
    # provisioning
    executor_startup_s: float = 30.0

    def ideal_read_bw(self, n_nodes: int) -> float:
        return n_nodes * self.disk_read_bw

    def ideal_readwrite_bw(self, n_nodes: int) -> float:
        # bytes moved per second when each task reads S then writes S locally
        per_node = 2.0 / (1.0 / self.disk_read_bw + 1.0 / self.disk_write_bw)
        return n_nodes * per_node


ANL_UC = TestbedSpec(
    name="ANL_UC",
    store_read_bw=425 * MB,
    store_write_bw=68.75 * MB,
    store_meta_latency_s=15e-3,
    store_open_latency_s=10e-3,
    disk_read_bw=128 * MB,
    disk_write_bw=28 * MB,
    nic_in_bw=125 * MB,
    nic_out_bw=125 * MB,
    local_open_latency_s=1e-3,
    peer_flow_cap=18 * MB,
    peer_setup_latency_s=50e-3,
    dispatch_service_s=1.0 / 3800.0,
    index_lookup_s=2e-6,
    dispatch_rtt_s=1.5e-3,
    task_overhead_s=50e-3,
    executor_startup_s=30.0,
)

#: canonical name -> spec registry (the experiment layer binds testbeds by
#: name so an ExperimentSpec stays a plain JSON document)
TESTBEDS: dict[str, TestbedSpec] = {
    "anl_uc": ANL_UC,
}

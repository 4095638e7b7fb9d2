# Copy of src/repro/core/arrays.py (the port imports nothing of repro).
"""Systolic-array timing & energy model (SOSA §3.1, §5, Table 2).

This module is the paper's hardware model, calibrated to its published
numbers:

  * PE energy           : 0.4 pJ / MAC  (TSMC 28nm @ 1 GHz, §5)
  * SRAM bank access    : 2.7 pJ / byte (Cacti-P, 256 KB banks, §5)
  * activations/weights : int8 (1 byte), partial sums: int16 (2 bytes)
  * interconnect        : mW/byte-per-cycle from Table 1 (per topology)

A weight-stationary r x c array streams, per cycle, through its *edges*:
  r bytes of activations in, c*2 bytes of partial sums in, c*2 bytes of
  partial sums out, and c bytes of weight prefetch (double buffering).
Hence memory traffic grows linearly with (r + 5c) while compute grows with
r*c — the core of the paper's granularity argument.

Validation (see tests/test_arrays.py): this model reproduces Table 2's
"Peak Power" column to within ~2% for every row, e.g. 113.2 W for the
512x512 monolithic and ~260 W for 256 pods of 32x32 with a Butterfly-2.
"""

from __future__ import annotations

import dataclasses
import math

# --- paper constants (§5) ---------------------------------------------------
E_MAC_PJ = 0.4            # energy per MAC, pJ
E_SRAM_PJ_PER_BYTE = 2.7  # SRAM bank access energy, pJ/byte
CLOCK_HZ = 1e9            # 1 GHz
ACT_BYTES = 1             # int8 activations
WEIGHT_BYTES = 1          # int8 weights
PSUM_BYTES = 2            # int16 partial sums
OPS_PER_MAC = 2           # multiply + add
TDP_WATTS = 400.0         # NVIDIA A100 product-brief TDP used by the paper


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """A weight-stationary systolic array (one pod's compute)."""

    rows: int = 32
    cols: int = 32
    # activation multicast / psum fan-in degrees (§4.1); only affect the
    # pipeline-latency term, not throughput or energy.
    multicast_u: int = 16
    fanin_v: int = 16
    clock_hz: float = CLOCK_HZ

    @property
    def num_pe(self) -> int:
        return self.rows * self.cols

    @property
    def edge_bytes_per_cycle(self) -> float:
        """Bytes crossing the array edge per cycle at full rate.

        acts in (r) + psums in (2c) + psums out (2c) + weight prefetch (c).
        """
        return (
            self.rows * ACT_BYTES
            + self.cols * PSUM_BYTES * 2
            + self.cols * WEIGHT_BYTES
        )

    @property
    def pipeline_latency(self) -> int:
        """Fill/drain latency of one tile op (§4.1): r/U + c/V cycles."""
        return int(
            math.ceil(self.rows / self.multicast_u)
            + math.ceil(self.cols / self.fanin_v)
        )

    # -- power -----------------------------------------------------------
    @property
    def pe_watts(self) -> float:
        return self.num_pe * E_MAC_PJ * 1e-12 * self.clock_hz

    @property
    def sram_watts(self) -> float:
        return self.edge_bytes_per_cycle * E_SRAM_PJ_PER_BYTE * 1e-12 * self.clock_hz

    @property
    def pod_watts(self) -> float:
        """Peak power of one pod, excluding the shared interconnect."""
        return self.pe_watts + self.sram_watts

    # -- throughput --------------------------------------------------------
    @property
    def peak_ops(self) -> float:
        """Peak ops/s (MACs count as 2 ops)."""
        return self.num_pe * OPS_PER_MAC * self.clock_hz

    # -- timing ------------------------------------------------------------
    def tile_exec_cycles(self, k: int) -> int:
        """Streaming cycles for a (k x r') @ (r' x c') tile op.

        Throughput-wise the array consumes one activation row per cycle, so a
        tile with k activation rows takes k cycles + fill/drain latency.
        With double buffering (Ross patent, §3.1) the *next* weight tile
        loads concurrently, taking `rows` cycles; if k < rows the array
        stalls for the remainder — the motivation for the r x r partition.
        """
        return max(k, self.rows) + self.pipeline_latency

    def tile_macs(self, k: int, r_eff: int, c_eff: int) -> int:
        return k * r_eff * c_eff


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """A multi-pod accelerator: N pods + interconnect + banks (Fig 7)."""

    array: ArrayConfig = ArrayConfig()
    num_pods: int = 256
    icn_mw_per_byte: float = 0.52  # Butterfly-2, Table 1
    tdp_watts: float = TDP_WATTS
    sram_bank_kb: int = 256        # §6.4 optimum

    @property
    def peak_watts(self) -> float:
        """Peak power: pods + interconnect moving edge bytes each cycle."""
        pods = self.array.pod_watts * self.num_pods
        icn_bytes_per_cycle = self.array.edge_bytes_per_cycle * self.num_pods
        icn = icn_bytes_per_cycle * self.icn_mw_per_byte * 1e-3
        return pods + icn

    @property
    def peak_ops(self) -> float:
        return self.array.peak_ops * self.num_pods

    @property
    def peak_ops_at_tdp(self) -> float:
        """Peak throughput normalized to the TDP (Table 2 'Peak Throughput
        @400W'): ops/s the design would deliver if scaled isopower to TDP."""
        return self.peak_ops * (self.tdp_watts / self.peak_watts)

    def effective_ops_at_tdp(self, utilization: float) -> float:
        return self.peak_ops_at_tdp * utilization


def max_pods_under_tdp(
    array: ArrayConfig,
    icn_mw_per_byte: float = 0.52,
    tdp_watts: float = TDP_WATTS,
    power_of_two: bool = True,
) -> int:
    """Largest pod count with peak power under TDP (§6 preamble).

    The paper picks the largest power-of-two pod count whose peak power is
    below the 400 W TDP.
    """
    per_pod = (
        array.pod_watts
        + array.edge_bytes_per_cycle * icn_mw_per_byte * 1e-3
    )
    n = max(1, int(tdp_watts // per_pod))
    if power_of_two:
        n = 2 ** int(math.floor(math.log2(n)))
    return n


def monolithic(rows: int, cols: int) -> AcceleratorConfig:
    """A single large array with no inter-pod interconnect (TPUv1-like)."""
    return AcceleratorConfig(
        array=ArrayConfig(rows=rows, cols=cols),
        num_pods=1,
        icn_mw_per_byte=0.0,
    )


def sosa(rows: int = 32, cols: int = 32, num_pods: int | None = None,
         icn_mw_per_byte: float = 0.52,
         tdp_watts: float = TDP_WATTS) -> AcceleratorConfig:
    """The paper's design point: pods sized r x c, pod count set by TDP."""
    arr = ArrayConfig(rows=rows, cols=cols)
    if num_pods is None:
        num_pods = max_pods_under_tdp(arr, icn_mw_per_byte, tdp_watts)
    return AcceleratorConfig(
        array=arr, num_pods=num_pods,
        icn_mw_per_byte=icn_mw_per_byte, tdp_watts=tdp_watts,
    )

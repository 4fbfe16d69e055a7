"""Accelerator and interconnect catalog (copy of
``repro/core/profiler/hw_specs.py``).

The Sailor paper (§4.1) profiles each GPU node type and fits per-link
bandwidth curves.  This module is the static half of that: published peak
specs for every accelerator the planner may allocate, plus link classes for
the bandwidth model in ``core/simulator/network.py``.

The catalog is the reference's, entry for entry, plus ``"H100"``: the card
the port runs on, whose kernel cost tables ``measured.calibrate_kernels``
measures.  The TPU entries stay so that plans over mixed fleets price the
same in both packages; none of their figures describes the port's card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """Peak specs of one accelerator chip."""

    name: str
    peak_flops: float          # FLOP/s at the training dtype (bf16/fp16 tensor)
    mem_bytes: float           # HBM capacity per chip
    mem_bw: float              # HBM bandwidth, bytes/s
    intra_node_bw: float       # NVLink / ICI per-chip bandwidth, bytes/s
    price_per_hour: float      # on-demand $ per chip-hour (representative)
    chips_per_node: int = 4    # default grouping into VMs / hosts
    # Sustained-efficiency knob: fraction of peak a well-tuned kernel reaches.
    # The analytic profiler multiplies peak by this (MFU-style derate).
    efficiency: float = 0.45
    # Fraction of HBM the runtime reserves before user allocations: CUDA
    # context + NCCL buffers on GPUs, TFRT/ICI scratch on TPUs.  The memory
    # model gates feasibility on ``usable_mem_bytes``, not raw capacity —
    # a plan sized to 100% of HBM OOMs in practice.
    reserved_mem_fraction: float = 0.06
    # Per-link collective-fabric bandwidth (one ICI link on TPUs), bytes/s.
    # 0 means "no dedicated per-link figure" — consumers fall back to
    # ``intra_node_bw`` (see ``collective_link_bw``).
    ici_bw: float = 0.0
    # Per-chip cross-pod / data-center-network bandwidth, bytes/s.
    # 0 means fall back to the generic "dcn" LinkSpec.
    dcn_bw: float = 0.0

    @property
    def collective_link_bw(self) -> float:
        """Bandwidth one collective ring runs at: the per-link ICI figure
        when the chip publishes one, else the full intra-node fabric."""
        return self.ici_bw or self.intra_node_bw

    @property
    def cross_pod_bw(self) -> float:
        """Per-chip bandwidth across pods/zones (DCN on TPUs)."""
        return self.dcn_bw or LINKS["dcn"].beta

    @property
    def price_per_sec(self) -> float:
        return self.price_per_hour / 3600.0

    @property
    def usable_mem_bytes(self) -> float:
        """HBM actually available to the training program."""
        return self.mem_bytes * (1.0 - self.reserved_mem_fraction)

    def roofline_time(self, flops: float, nbytes: float) -> float:
        """max(compute, bandwidth) seconds — the analytic per-op guess a
        measured kernel cost table (``core/profiler/kernel_costs.py``)
        overrides where it has coverage."""
        return max(flops / (self.peak_flops * self.efficiency),
                   nbytes / self.mem_bw)


# --- catalog -----------------------------------------------------------------
# Peak numbers from public datasheets. price = representative on-demand GCP.
ACCELERATORS: Dict[str, AcceleratorSpec] = {
    # The reproduction target (task spec constants).
    "tpu-v5e": AcceleratorSpec(
        name="tpu-v5e", peak_flops=197e12, mem_bytes=16e9, mem_bw=819e9,
        intra_node_bw=4 * 50e9,  # 4 ICI links x ~50 GB/s
        price_per_hour=1.20, chips_per_node=4, efficiency=0.55,
        reserved_mem_fraction=0.08,    # TFRT + ICI scratch
        ici_bw=50e9, dcn_bw=25e9),
    "tpu-v5p": AcceleratorSpec(
        name="tpu-v5p", peak_flops=459e12, mem_bytes=95e9, mem_bw=2765e9,
        intra_node_bw=6 * 100e9,
        price_per_hour=4.20, chips_per_node=4, efficiency=0.55,
        reserved_mem_fraction=0.08, ici_bw=100e9, dcn_bw=25e9),
    # Paper hardware.
    "A100-40": AcceleratorSpec(
        name="A100-40", peak_flops=312e12, mem_bytes=40e9, mem_bw=1555e9,
        intra_node_bw=600e9, price_per_hour=3.67, chips_per_node=4,
        efficiency=0.45),
    "V100-16": AcceleratorSpec(
        name="V100-16", peak_flops=125e12, mem_bytes=16e9, mem_bw=900e9,
        intra_node_bw=300e9, price_per_hour=2.48, chips_per_node=4,
        efficiency=0.40),
    "GH200": AcceleratorSpec(
        name="GH200", peak_flops=990e12, mem_bytes=96e9, mem_bw=4000e9,
        intra_node_bw=900e9, price_per_hour=11.06, chips_per_node=4,
        efficiency=0.45),
    # The port's card: H100 SXM (NVIDIA data sheet, dense bf16 tensor-core
    # rate, 80 GB HBM3 at 3.35 TB/s, NVLink 900 GB/s, 8 per HGX node).
    # Price: GCP a3-highgpu-8g (8x H100 80GB) on demand in us-central1,
    # $88.49 per hour / 8 GPUs, GCP's Compute Engine GPU price list, 2024.
    # efficiency 0.45 as for the other NVIDIA entries: uncalibrated until
    # the port's calibrate_cpu_host counterpart (training slice) fits it;
    # the measured kernel tables already price the custom kernels.
    "H100": AcceleratorSpec(
        name="H100", peak_flops=989e12, mem_bytes=80e9, mem_bw=3.35e12,
        intra_node_bw=900e9, price_per_hour=11.06, chips_per_node=8,
        efficiency=0.45),
    "RTX-3090": AcceleratorSpec(
        name="RTX-3090", peak_flops=71e12, mem_bytes=24e9, mem_bw=936e9,
        intra_node_bw=64e9, price_per_hour=1.10, chips_per_node=8,
        efficiency=0.35),
    "TITAN-RTX": AcceleratorSpec(
        name="TITAN-RTX", peak_flops=65e12, mem_bytes=24e9, mem_bw=672e9,
        intra_node_bw=64e9, price_per_hour=0.90, chips_per_node=8,
        efficiency=0.35),
    "RTX-2080": AcceleratorSpec(
        name="RTX-2080", peak_flops=40e12, mem_bytes=11e9, mem_bw=616e9,
        intra_node_bw=32e9, price_per_hour=0.60, chips_per_node=8,
        efficiency=0.35),
    # Calibrated against this container in core/profiler/measured.py.
    # No reservation: host RAM has no resident driver/runtime carve-out,
    # and memory calibration fits against it directly.
    "cpu-host": AcceleratorSpec(
        name="cpu-host", peak_flops=50e9, mem_bytes=8e9, mem_bw=10e9,
        intra_node_bw=10e9, price_per_hour=0.10, chips_per_node=1,
        efficiency=1.0, reserved_mem_fraction=0.0),
}

# --- roofline constants for the dry-run target (task spec) -------------------
V5E_PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
V5E_HBM_BW = 819e9               # bytes/s per chip
V5E_ICI_BW = 50e9                # bytes/s per ICI link
V5E_DCN_BW = 25e9                # bytes/s per chip across pods (assumed DCN)


# --- link classes -------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """alpha-beta model of one link class: t(n) = alpha + n / beta.

    The paper fits a polynomial of measured bandwidth vs message size; the
    alpha-beta form is the standard 2-term fit and what our measured profiler
    produces.  ``price_per_byte`` covers cloud egress fees (zero inside a
    zone).
    """

    name: str
    alpha: float               # startup latency, seconds
    beta: float                # asymptotic bandwidth, bytes/s
    price_per_byte: float = 0.0

    def time(self, nbytes: float) -> float:
        return self.alpha + nbytes / self.beta


LINKS: Dict[str, LinkSpec] = {
    # Within one node / one TPU slice neighbourhood.
    "intra-node": LinkSpec("intra-node", alpha=5e-6, beta=200e9),
    "ici": LinkSpec("ici", alpha=2e-6, beta=V5E_ICI_BW),
    # Node-to-node inside one zone (GCP 100 Gb/s NIC ~ 12.5 GB/s).
    "intra-zone": LinkSpec("intra-zone", alpha=30e-6, beta=12.5e9),
    # Across zones within a region (paper H6: same order as intra-zone).
    "inter-zone": LinkSpec("inter-zone", alpha=200e-6, beta=10e9,
                           price_per_byte=0.01 / 1e9),
    # Across regions (paper: much slower + expensive egress).
    "inter-region": LinkSpec("inter-region", alpha=5e-3, beta=1.25e9,
                             price_per_byte=0.02 / 1e9),
    # Across pods over DCN (TPU multi-pod analog of inter-zone).
    "dcn": LinkSpec("dcn", alpha=100e-6, beta=V5E_DCN_BW),
}


def kernel_table_path(chip: str) -> "os.PathLike":
    """Default on-disk home of a chip's calibrated kernel cost table
    (same cache root the kernel autotuner uses)."""
    import os
    from pathlib import Path
    root = Path(os.environ.get("REPRO_KERNEL_CACHE_DIR",
                               Path.home() / ".cache" / "repro-kernels"))
    return root / f"kernel-costs-{chip}.json"


def get_accelerator(name: str) -> AcceleratorSpec:
    try:
        return ACCELERATORS[name]
    except KeyError as e:
        raise KeyError(
            f"unknown accelerator {name!r}; known: {sorted(ACCELERATORS)}") from e


def get_link(name: str) -> LinkSpec:
    try:
        return LINKS[name]
    except KeyError as e:
        raise KeyError(f"unknown link {name!r}; known: {sorted(LINKS)}") from e

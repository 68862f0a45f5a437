"""Calibrated device/link constants for the paper's platforms (Tables I-II).

A copy of ``repro.core.calibration`` for the port: the paper's
anchors and the constants of its modeled devices, not
measurements of the port.

The paper reports *measured* inference times on three devices the port does
not run on (ODROID N2 / Mali G52, Intel Atom N270, Intel i7-8650U). To
reproduce the partition-point sweeps (Figs 4-6) we calibrate an analytic
per-device model

    t_actor = overhead + max(flops / FLOPS, weight_bytes / MEM_BW)

against the paper's own anchor measurements, then *predict* every other
point of the sweeps and check the optimal partition points and speedups
match. Derivations:

Vehicle CNN (Fig 2, input 96x96x3 fp32 = 110592 B/token):
  * token sizes: L1->L2 = 294912 B = 48x48x32 fp32, L2->L3 = 73728 B =
    24x24x32 fp32 — both match the paper's figure exactly, fixing the
    layer geometry (conv 5x5x32 + maxpool/2, twice; then dense 100, 100,
    n_classes).
  * N2 full-endpoint = 18.9 ms and PP3 endpoint time = 14.9 ms with a
    73728 B boundary token over 11.2 MB/s Ethernet (6.6 ms) imply
    conv-compute(L1+L2) ~ 8.3 ms -> N2 conv throughput ~ 19.5 GFLOP/s,
    and dense-side (L3..L5) ~ 10.6 ms, dominated by L3's 7.37 MB weight
    read -> effective FC bandwidth ~ 0.77 GB/s (ARM CL fp32 FC on Mali).
  * N270 full-endpoint = 443 ms -> ~0.38 GFLOP/s plain-C throughput, with
    PP2 = 167 ms (Ethernet) pinning conv1 time ~ 140 ms.
  * i7 server: calibrated from the end-to-end latency split (Sec IV.D:
    6.3 ms for L3..L5 on oneDNN) -> FC bandwidth ~ 1.3 GB/s effective,
    conv throughput ~ 40 GFLOP/s (never the bottleneck in the sweeps).

Known residual (documented, not hidden): the paper's PP3-on-WiFi point
(17.1 ms) implies an *effective* in-application WiFi throughput of
~8.4 MB/s, higher than Table II's synthetic 2.3 MB/s measurement —
consistent with socket buffering overlapping computation during the
pipelined 384-frame run. We therefore keep two link models per network:
``synthetic`` (Table II) and ``effective`` (calibrated); EXPERIMENTS.md
reports the sweep under both.

SSD-Mobilenet (Fig 3): N2 full-endpoint = 2360 ms over ~2.44 GFLOP of
conv work -> ~1.0 GFLOP/s effective OpenCL throughput (depthwise convs
have very low arithmetic intensity on Mali); best Ethernet partition
(after DWCL9) = 406 ms = 5.8x, WiFi best 470 ms at PP9.
"""
from __future__ import annotations

# Effective sustained conv/GEMM throughput (FLOP/s), calibrated as above.
N2_FLOPS = 19.5e9          # Mali G52, ARM CL conv layers
N2_FC_MEM_BW = 0.77e9      # Mali G52, ARM CL fully-connected weight read
N2_OPENCL_FLOPS = 1.03e9   # Mali G52, generic OpenCL kernels (SSD-Mobilenet)
N270_FLOPS = 0.382e9       # Atom N270, plain C
N270_FC_MEM_BW = 0.30e9
I7_FLOPS = 40e9            # i7-8650U, oneDNN
I7_FC_MEM_BW = 1.3e9
I7_OPENCL_FLOPS = 6.0e9    # i7 UHD 620, OpenCL (SSD-Mobilenet server side)

# Per-firing overhead: thread wakeup + kernel launch.
N2_FIRING_OVERHEAD_S = 2.5e-4
N270_FIRING_OVERHEAD_S = 1.0e-4
I7_FIRING_OVERHEAD_S = 1.0e-4

# Link models: (bandwidth bytes/s, latency s, overlap). ``synthetic`` =
# Table II measured throughput, additive cost; ``effective`` = calibrated
# in-application behaviour. Calibration finding (documented residual): the
# paper's N2 WiFi sweep is only self-consistent if transmission OVERLAPS
# endpoint compute (socket buffering) at ~4.3 MB/s sustained: then
# PP3 = max(9.1 ms compute, 73728 B / 4.31 MB/s) = 17.1 ms  (paper: 17.1)
# PP1 = max(~0,      110592 B / 4.31 MB/s) = 25.7 ms  > 18.9 full-endpoint
# both matching Sec IV.B. The Ethernet path is CPU-bound (100 Mbit NIC)
# and behaves additively at the Table II throughput.
LINKS = {
    ("N2", "ethernet", "synthetic"):   (11.2e6, 1.49e-3, False),
    ("N2", "ethernet", "effective"):   (11.2e6, 1.49e-3, False),
    ("N2", "wifi", "synthetic"):       (2.3e6, 2.15e-3, False),
    ("N2", "wifi", "effective"):       (4.31e6, 2.15e-3, True),
    # SSD tokens (739 KB) far exceed the socket buffer, so WiFi transfers
    # cannot fully overlap compute there: additive at the sustained rate.
    ("N2", "wifi", "ssd_effective"):   (4.31e6, 2.15e-3, False),
    ("N270", "ethernet", "synthetic"): (11.2e6, 1.21e-3, False),
    ("N270", "ethernet", "effective"): (11.2e6, 1.21e-3, False),
    ("N270", "wifi", "synthetic"):     (4.7e6, 1.22e-3, False),
    ("N270", "wifi", "effective"):     (4.7e6, 1.22e-3, False),
}

# SSD-Mobilenet per-actor calibration (N2 OpenCL). Three regimes govern
# Mali OpenCL layer times:  t = ovh + max(conv_flops/CONV, dw_flops/DW,
# activation_traffic/MEM_BW).  The early high-resolution blocks are
# MEMORY-bound (large feature maps through a ~0.2 GB/s effective OpenCL
# buffer path), which is exactly why the paper's optimal Ethernet cut sits
# as deep as DWCL9: everything before it is expensive per FLOP, everything
# after it is cheap-but-large-weights, and the 19x19x512 token (739328 B)
# is the first 'cheap to ship' boundary. Constants solved against the
# paper's anchors: full-endpoint 2360 ms, best-Ethernet 406 ms at
# Input..DWCL9, best-WiFi 470 ms (Sec IV.B).
N2_SSD_CONV_FLOPS = 9.5e9    # pointwise / standard convs, OpenCL on Mali
N2_SSD_DW_FLOPS = 1.2e9      # depthwise convs, OpenCL on Mali
N2_SSD_MEM_BW = 0.26e9       # effective OpenCL activation r/w bandwidth
N2_SSD_NMS_S = 0.26          # plain-C NMS over 1917 priors x classes
N2_SSD_TRACKER_S = 1.62      # plain-C object tracker
# CPU cost of shipping a byte off the N2 during the SSD runs: OpenCL
# buffer readback from the Mali + socket syscalls (~17 MB/s effective);
# the ARM CL vehicle pipeline keeps tensors CPU-side (zero readback).
N2_SSD_TX_COST_PER_BYTE = 56e-9
I7_SSD_SPEEDUP = 8.0         # i7 UHD620 OpenCL vs Mali, per actor

# Sec IV.D: "inference time for single images [is] much slower than
# inference for image sequences due to CPU cache behavior" — single-frame
# endpoint compute runs cache-cold. Calibrated from 17.5 ms single-frame
# vs 9.07 ms pipelined for Input+L1+L2 on the N2.
N2_COLD_START_FACTOR = 1.93

# Paper anchor measurements (seconds) used for validation in the benchmarks.
PAPER_ANCHORS = {
    "vehicle_n2_full_endpoint": 18.9e-3,
    "vehicle_n2_pp3_ethernet": 14.9e-3,
    "vehicle_n2_pp3_wifi": 17.1e-3,
    "vehicle_n2_pp1_ethernet": 9.0e-3,
    "vehicle_n270_full_endpoint": 443e-3,
    "vehicle_n270_pp2_ethernet": 167e-3,
    "vehicle_n270_pp2_wifi": 191e-3,
    "ssd_n2_full_endpoint": 2360e-3,
    "ssd_n2_best_ethernet": 406e-3,
    "ssd_n2_best_wifi": 470e-3,
    "ssd_speedup": 5.8,
    "latency_e2e": 31.2e-3,
    "latency_split": (0.57, 0.23, 0.20),  # endpoint / network / server
}

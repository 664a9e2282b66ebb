"""Analytic communication model for the sharded north-star chain — the
transferable form of the gloo scaling evidence (benchmarks/
scaling_report.json is measured on a 4-core CPU box whose transport is
orders of magnitude slower than NVLink; this model translates the DESIGN
— bytes and collective rounds per step — onto H100 NVLink numbers).

Per weak-scaling step each block shard exchanges fixed-size halos with its
neighbors (sizes depend only on the operator geometry, NOT on N or the
per-shard length), so the comm/compute ratio is:

    eff(N>=2) = T_compute / (T_compute + rounds * t_lat + bytes / BW)

All halo payloads are neighbor exchanges (jax.lax.ppermute with +-1
shifts), except the IIR state fix-up which all_gathers 2
floats/channel/shard. The four cards of one host are joined all to all.

NVIDIA H100 SXM data sheet: 900 GB/s of NVLink per card, 450 GB/s each
way. The 2 us charged per round for launch + sync is an estimate, not a
measurement.

Run: python scripts/comm_model.py [--out benchmarks/comm_model.json]
"""

import argparse
import json
import math
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
import sys
sys.path.insert(0, REPO)


def chain_comm(per_device_samples: int, channels: int,
               fir_taps: int = 1024, up: int = 4, down: int = 3,
               nfft: int = 2048, hop: int = 512, fused: bool = True,
               dtype_bytes: int = 4):
    """Bytes and neighbor-rounds per chain step for one block shard."""
    from vv_dsp_tpu.ops import resample as _rs

    h = _rs._resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    taps_pp = -(-len(h) // up)
    overlap = nfft - hop
    t = per_device_samples

    if fused:
        # one combined left+right raw-signal exchange
        # (models/pipeline.py::_apply_sharded_fused dependency cone)
        HL = fir_taps - 1 + max(0, taps_pp - 1 - half_len // up) + 1
        ext_out = t * up // down + overlap
        HR = max(0, (half_len + (ext_out - 1) * down) // up - (t - 1)) + 1
        stages = [("fused left halo", HL * channels * dtype_bytes, 1),
                  ("fused right halo", HR * channels * dtype_bytes, 1)]
    else:
        stages = [
            ("FIR left halo", (fir_taps - 1) * channels * dtype_bytes, 1),
            ("poly left halo", (taps_pp - 1) * channels * dtype_bytes, 1),
            ("poly right halo",
             (-(-half_len // up) + 1) * channels * dtype_bytes, 1),
            ("STFT right halo", overlap * channels * dtype_bytes, 1),
        ]
    return stages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-samples", type=int, default=393216)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--link-bw", type=float, default=4.5e11,
                    help="NVLink bytes/s each way per card (H100)")
    ap.add_argument("--round-latency", type=float, default=2e-6,
                    help="charged per collective round (launch+sync+hop)")
    ap.add_argument("--chain-msps", type=float, default=4605.0,
                    help="single-card chain throughput -> per-step "
                         "compute time (16 ch x 479,232 in 1.665 ms on "
                         "one H100 SXM at 700 W)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "benchmarks", "comm_model.json"))
    args = ap.parse_args()

    n_samp = args.per_device_samples * args.channels
    t_compute = n_samp / (args.chain_msps * 1e6)

    report = {"params": {
        "per_device_samples": args.per_device_samples,
        "channels": args.channels,
        "link_bytes_per_s": args.link_bw,
        "round_latency_s": args.round_latency,
        "single_chip_chain_msps": args.chain_msps,
        "t_compute_s": t_compute,
    }, "variants": {}}

    for fused in (False, True):
        stages = chain_comm(args.per_device_samples, args.channels,
                            fused=fused)
        total_bytes = sum(b for _, b, _ in stages)
        rounds = sum(r for _, _, r in stages)
        t_comm = rounds * args.round_latency + total_bytes / args.link_bw
        eff = t_compute / (t_compute + t_comm)
        key = "fused_halos" if fused else "staged"
        report["variants"][key] = {
            "stages": [{"name": nm, "bytes": b, "rounds": r}
                       for nm, b, r in stages],
            "total_bytes_per_step": total_bytes,
            "collective_rounds_per_step": rounds,
            "t_comm_s": t_comm,
            "predicted_efficiency_N>=2": eff,
        }
        print(f"{key}: {rounds} rounds, {total_bytes/1024:.1f} KiB/step, "
              f"t_comm {t_comm*1e6:.2f} us vs t_compute "
              f"{t_compute*1e6:.0f} us -> predicted weak-scaling "
              f"efficiency {eff:.4f}", flush=True)

    report["notes"] = (
        "Halo payloads are geometry-constants (independent of N and nearly "
        "independent of per-shard length), so predicted efficiency is flat "
        "in N for N >= 2. The gloo box measures 0.93 (N=2) / 0.846 (N=4) "
        "because its transport latency is far above NVLink's and every "
        "collective synchronizes oversubscribed CPU processes. IIR (not "
        "in the chain) adds one all_gather of 2 floats/channel/shard.")
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

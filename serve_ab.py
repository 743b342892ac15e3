#!/usr/bin/env python3
"""A/B timing of the port's serve phase: this checkout against another one.

    python3 serve_ab.py OTHER_CHECKOUT [--pairs 10]

OTHER_CHECKOUT is a second copy of the repository, for example the parent
commit unpacked with `git archive`. One worker process per checkout imports
that checkout's own `chip_smoke.py` and `nerfsys_tpu_torch`, builds its
kernels, sets up chip_smoke's bench-width soft-occupancy serve configuration
(K=4, seed 0) and renders one warm-up frame. Then the workers take rounds in
the order other, this, this, other, other, this, ... (`--pairs` pairs). A
round renders chip_smoke's three 800x800 poses through `render_image` and
reports each frame's ms on the host clock, ending with the frame on the
host, and the host ms of `frame_rays` for the first pose. A worker waits on
its pipe between rounds, so one renders at a time.

Prints every round, then for each side the median, quartiles and range of
the round means; the difference of the medians against the other side's
quartile spread, whether this median lies inside the other's range, and
in how many pairs this side was faster; and the card's name and power
limit. Exits non-zero if the two checkouts render
different images. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SIDES = ("other", "this")


def worker(root: Path) -> int:
    sys.path[0] = str(root)  # that checkout's modules, not this script's
    import torch

    import chip_smoke as cs
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    kernels.build_all()
    device = torch.device("cuda", 0)
    torch.manual_seed(cs.SEED)
    cfg, statics, params, occ = cs.bench_setup(device)
    S = 32
    chunk = default_chunk_rays(S)
    aabb = statics.global_aabb.cpu().numpy()
    renderer = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                                   occ_importance=True, occ_hard_mask=False,
                                   device=device)
    poses = [cs.pose((0.0, 0.0, 2.0)), cs.pose((0.1, 0.0, 2.0)),
             cs.pose((0.0, -0.1, 2.1))]
    render_image(renderer, params, statics, poses[0], scene_aabb=aabb,
                 chunk_rays=chunk)  # warm-up
    torch.cuda.synchronize()
    print(json.dumps({"ready": str(root)}), flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        ms = []
        for md in poses:
            t0 = time.perf_counter()
            rgb, _, _ = render_image(renderer, params, statics, md,
                                     scene_aabb=aabb, chunk_rays=chunk)
            ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        frame_rays(poses[0].H, poses[0].W, poses[0].intrinsics,
                   poses[0].c2w, aabb=aabb)
        raygen_ms = 1e3 * (time.perf_counter() - t0)
        print(json.dumps({"ms": ms, "raygen_ms": raygen_ms,
                          "mean_rgb": float(rgb.mean())}), flush=True)
    return 0


def _reply(proc) -> dict:
    """The worker's next JSON line (other lines pass through)."""
    while True:
        line = proc.stdout.readline()
        if not line:
            raise SystemExit(f"serve_ab: worker {proc.args[-1]} ended")
        if line.startswith("{"):
            return json.loads(line)
        print(line, end="")


def summarize(rounds, roots):
    """Per side: median, quartiles and range of the round means; and the
    verdict of this side against the other, pair by pair."""
    summary = {}
    for name in SIDES:
        means = [r["mean_ms"] for r in rounds[name]]
        q1, med, q3 = statistics.quantiles(means, n=4)
        summary[name] = {
            "root": str(roots[name]), "round_mean_ms": means,
            "median_ms": med, "q1_ms": q1, "q3_ms": q3,
            "min_ms": min(means), "max_ms": max(means),
            "raygen_median_ms": statistics.median(
                r["raygen_ms"] for r in rounds[name]),
            "mean_rgb": rounds[name][-1]["mean_rgb"]}
    o, t = summary["other"], summary["this"]
    verdict = {
        "median_diff_ms": t["median_ms"] - o["median_ms"],
        "other_quartile_spread_ms": o["q3_ms"] - o["q1_ms"],
        "this_median_inside_other_range": (
            o["min_ms"] <= t["median_ms"] <= o["max_ms"]),
        "pairs_this_faster": sum(a < b for a, b in zip(
            t["round_mean_ms"], o["round_mean_ms"])),
        "pairs": len(rounds["this"])}
    return summary, verdict


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.other.resolve())
    if args.pairs < 2:
        ap.error("--pairs must be at least 2 (quartiles)")
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 1
    roots = {"other": args.other.resolve(),
             "this": Path(__file__).resolve().parent}
    for name, root in roots.items():
        if not (root / "chip_smoke.py").is_file():
            print(f"serve_ab: no chip_smoke.py in {root}", file=sys.stderr)
            return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    procs = {name: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(root)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True) for name, root in roots.items()}
    try:
        for name in SIDES:
            _reply(procs[name])
        rounds = {name: [] for name in SIDES}
        for i in range(args.pairs):
            for name in (SIDES if i % 2 == 0 else SIDES[::-1]):
                procs[name].stdin.write("run\n")
                procs[name].stdin.flush()
                r = _reply(procs[name])
                r["mean_ms"] = sum(r["ms"]) / len(r["ms"])
                rounds[name].append(r)
                print(f"round {i} {name}: ms_per_frame="
                      f"{[round(x, 2) for x in r['ms']]} mean_ms="
                      f"{r['mean_ms']:.2f} raygen_ms={r['raygen_ms']:.2f}",
                      flush=True)
    finally:
        for p in procs.values():
            if p.stdin and not p.stdin.closed:
                p.stdin.close()
        for p in procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    summary, verdict = summarize(rounds, roots)
    for name in SIDES:
        s = summary[name]
        print(f"{name}: median_ms={s['median_ms']:.2f} quartiles_ms="
              f"[{s['q1_ms']:.2f}, {s['q3_ms']:.2f}] range_ms="
              f"[{s['min_ms']:.2f}, {s['max_ms']:.2f}] "
              f"raygen_median_ms={s['raygen_median_ms']:.2f} "
              f"({s['root']})")
    print(f"this - other median: {verdict['median_diff_ms']:.2f} ms; "
          f"other's quartile spread {verdict['other_quartile_spread_ms']:.2f}"
          f" ms; this faster in {verdict['pairs_this_faster']} of "
          f"{args.pairs} pairs")
    print(json.dumps({"serve_ab": summary, "verdict": verdict}))
    print(card)
    if abs(summary["this"]["mean_rgb"] - summary["other"]["mean_rgb"]) > 1e-4:
        print("serve_ab: the two checkouts render different images",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Design experiments on kernel 3 (the inverse-CDF sampler), 10a-i (the
bucket dispatch), 10a-iii (the blend's transpose), 10b (the
coherent-expert test) and row 8 (the segment compositor): variants of
their CUDA sources, built beside the shipped libraries and timed through
the shipped wrappers at the real shapes.

    python3 kernel_ab.py [--rounds 5]

Needs one CUDA card and nvcc. Each variant is the shipped source with a
few lines replaced (`VARIANTS`); it is built with the shipped flags into
`nerfsys_tpu_torch/_build/variants/` (all nvcc runs at once) and swapped
in for the shipped entry point, so the wrapper's plan, checks and launch
path are the shipped ones. The cases are `serve_ab.py --phase kernels`'s:
kernel 3 at the serve chunk (65,536 rays x 32 samples, P=128, shared
targets) and at one inner step (4,000 rays, per-ray jittered targets),
10a-i at the serve chunk's 2,097,152 points (K=4, E=1 and 2, cf 1.5) and
on one chunk of the K=16 arm (196,608 points, E=2), 10b at the serve
chunk's and a skew chunk's 65,536 x 32 samples, row 8 at the first
segment (65,536 x 8) and a resume slice (16,384 x 24), 10a-iii on the
top-2 dispatches of the serve chunk and of the K=16 chunk. A variant that
keeps the outputs is first held to the plain version on every case of its
kernel (the sampler within 1e-5, the dispatch's integer outputs equal and
its weights within 1e-6 on two calls, 10b's ids equal, row 8 within
1e-5, 10a-iii equal); a timing-only variant (its outputs incomplete) is
not. Then `--rounds` rounds time every variant and the shipped kernel on
every case by device time (chip_smoke's `device_ms`), in turn; the script
prints each variant's ptxas register count, each round, and the median
and range per
(variant, case).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name -> (library stem, timing only, [(shipped text, variant text)], the
# Python side's matching change: {"tile": the dispatch's tile for E <= 2},
# {"groups": 10b's ray groups a warp} or {"lanes": 10b's lanes a ray at
# most}, else None).
# "{sms}" in a variant text is the card's SM count.
VARIANTS = {
    "3: 16 blocks an SM (the grid before the occupancy cap)": (
        "occ_sample", False,
        [("kern<<<min(plan.blocks, resident),",
          "kern<<<min(plan.blocks, 16 * {sms}),")], None),
    "3: literal count on every row": (
        "occ_sample", False,
        [("const bool search = __all_sync(FULL_MASK, mono);",
          "const bool search = false;")], None),
    "3: rank sort on every row": (
        "occ_sample", False,
        [("const bool sorted = __all_sync(FULL_MASK, in_order);",
          "const bool sorted = false;")], None),
    "3: both (the count and the rank sort of every row)": (
        "occ_sample", False,
        [("const bool search = __all_sync(FULL_MASK, mono);",
          "const bool search = false;"),
         ("const bool sorted = __all_sync(FULL_MASK, in_order);",
          "const bool sorted = false;")], None),
    "10a-i: tiles of 256 at E <= 2": (
        "bucket", False,
        [("#define DISPATCH_PPT_E12 8", "#define DISPATCH_PPT_E12 1")],
        {"tile": 256}),
    "10a-i: no rows phase (timing only)": (
        "bucket", True,
        [("for (int p0 = 0; p0 < total; p0 += GATHER) {",
          "for (int p0 = 0; p0 < 0; p0 += GATHER) {")], None),
}
VARIANTS.update({
    f"10b: {g} ray group{'s' if g > 1 else ''} a warp": (
        "coherent", False,
        [("#define COHERENT_GROUPS 2", f"#define COHERENT_GROUPS {g}")],
        {"groups": g})
    for g in (1, 4, 8)})
VARIANTS.update({
    f"10b: pieces of {w} lanes": ("coherent", False, [], {"lanes": w})
    for w in (4, 16, 32)})
VARIANTS["8: the carry read first"] = (
    "composite_seg", False,
    [("    float T = 1.0f;  // the product of the pieces before",
      "    float pre[8];  // output q's carry value, by the lane that writes"
      " it\n#pragma unroll\n    for (int q = 0; q < 8; ++q)\n"
      "        pre[q] = live && q < (FOG ? 8 : 6) && q != 5 &&\n"
      "                 (q & (W - 1)) == sl\n"
      "            ? __ldg(q < 3 ? c_rgb + ray * 3 + q\n"
      "                    : q == 3 ? c_depth + ray : q == 4 ? c_acc + ray\n"
      "                    : q == 6 ? c_wmax + ray : c_wlogw + ray)\n"
      "            : 0.0f;\n"
      "    float T = 1.0f;  // the product of the pieces before"),
     ("__ldg(c_rgb + ray * 3) + cr", "pre[0] + cr"),
     ("__ldg(c_rgb + ray * 3 + 1) + cg", "pre[1] + cg"),
     ("__ldg(c_rgb + ray * 3 + 2) + cb", "pre[2] + cb"),
     ("__ldg(c_depth + ray) + depth", "pre[3] + depth"),
     ("__ldg(c_acc + ray) + acc", "pre[4] + acc"),
     ("fmaxf(__ldg(c_wmax + ray), wmax)", "fmaxf(pre[6], wmax)"),
     ("__ldg(c_wlogw + ray) + wlogw", "pre[7] + wlogw")], None)
VARIANTS["10a-iii: the tail fill as a second launch"] = (
    "bucket", False,
    [("""    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<n_fill + plan.tiles, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            n_fill, plan.fill_blocks);""",
      """    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<n_fill, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            n_fill, plan.fill_blocks);
    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<plan.tiles, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            0, plan.fill_blocks);""")],
    {"kernel": "BUCKET_COMBINE_BWD"})
VARIANTS["10a-iii: each run written by the whole block"] = (
    "bucket", False,
    [("""    const int warp = tid >> 5, lane = tid & 31;
    for (int k = warp; k < K; k += COMBINE_WARPS) {""",
      """    const int lane = tid;
    for (int k = 0; k < K; ++k) {"""),
     ("write_run(g_sigma_b, s_sig + off, start, cnt, lane, 32);",
      "write_run(g_sigma_b, s_sig + off, start, cnt, lane, "
      "COMBINE_THREADS);"),
     ("""3 * cnt, lane,
                      32);""", """3 * cnt, lane,
                      COMBINE_THREADS);""")],
    {"kernel": "BUCKET_COMBINE_BWD"})
# the kernel a variant of each library replaces unless it names another
KERNEL_OF = {"occ_sample": "OCC_SAMPLE", "bucket": "BUCKET_DISPATCH",
             "coherent": "COHERENT_EXPERT", "composite_seg": "COMPOSITE_SEG"}
# each kernel's cases in `serve_ab.kernel_cases`
CASES_OF = {"OCC_SAMPLE": (0, 1), "BUCKET_DISPATCH": (2, 3, 4),
            "COHERENT_EXPERT": (5, 6), "COMPOSITE_SEG": (7, 8),
            "BUCKET_COMBINE_BWD": (9, 10)}


def kernel_of(name: str) -> str:
    """The kernels attribute that variant `name` replaces."""
    stem, _, _, patch = VARIANTS[name]
    return (patch or {}).get("kernel", KERNEL_OF[stem])


def build_variants(kernels, sms: int):
    """Writes and builds every variant in parallel; returns name ->
    (library path, ptxas lines)."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (stem, _, reps, _)) in enumerate(VARIANTS.items()):
        src_name, extra = kernels.SOURCES[stem]
        text = (kernels.CSRC / src_name).read_text()
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"kernel_ab: {name}: the shipped source "
                                 f"no longer holds {old!r} once")
            text = text.replace(old, new.replace("{sms}", str(sms)))
        src = out_dir / f"v{i}_{src_name}"
        src.write_text(text)
        lib = out_dir / f"libv{i}_{stem}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *extra, "-I",
               str(kernels.CSRC), "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"kernel_ab: nvcc failed for {name}:\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln])
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    import chip_smoke as cs
    import serve_ab
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import container as CO

    print(cs.card_line(), flush=True)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stems = sorted({getattr(kernels, k).stem for k in CASES_OF})
    kernels.build_all(tuple(stems))
    for stem in stems:
        for ln in kernels.build_log.get(stem, "").splitlines():
            if "registers" in ln:
                print(f"shipped {stem}: {ln.strip()}", flush=True)
    built = build_variants(kernels, sms)
    for name, (_, regs) in built.items():
        for ln in regs:
            print(f"{name}: {ln}", flush=True)
    torch.manual_seed(cs.SEED)
    cfg, statics, params, occ = cs.bench_setup(device)
    cases = serve_ab.kernel_cases(cs, cfg, statics, params, occ, device)
    for case, _, check in cases:  # also loads the shipped entry points
        print(f"shipped / {case}: {check()[0]}", flush=True)
    shipped = {k: getattr(kernels, k) for k in CASES_OF}
    fns = {k: kern._fn for k, kern in shipped.items()}
    shipped_tile = CO.dispatch_tile
    shipped_10b = {at: getattr(CO, at) for at in ("COHERENT_GROUPS",
                                                  "COHERENT_LANES")}

    def use(name):
        """Swaps variant `name` (None: the shipped kernels) in."""
        for k, kern in shipped.items():
            kern._fn = fns[k]
        CO.dispatch_tile = shipped_tile
        CO._dispatch_plan.cache_clear()
        for at, v in shipped_10b.items():
            setattr(CO, at, v)
        if name is None:
            return
        _, _, _, patch = VARIANTS[name]
        kern = shipped[kernel_of(name)]
        lib = ctypes.CDLL(str(built[name][0]))
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes
        fn.restype = ctypes.c_int
        kern._fn = fn
        if patch and "tile" in patch:
            CO.dispatch_tile = (lambda e: patch["tile"] if e <= 2
                                else shipped_tile(e))
        if patch and "groups" in patch:
            CO.COHERENT_GROUPS = patch["groups"]
        if patch and "lanes" in patch:
            CO.COHERENT_LANES = patch["lanes"]

    for name, (stem, timing_only, _, _) in VARIANTS.items():
        if timing_only:
            continue
        use(name)
        for i in CASES_OF[kernel_of(name)]:
            text, _ = cases[i][2]()
            print(f"{name} / {cases[i][0]}: {text}", flush=True)
    use(None)
    names = [None, *VARIANTS]
    times = {(n, i): [] for n in names for i in range(len(cases))}
    for r in range(args.rounds):
        for name in names:
            use(name)
            idx = (range(len(cases)) if name is None
                   else CASES_OF[kernel_of(name)])
            row = []
            for i in idx:
                ms = cs.device_ms(cases[i][1])
                times[(name, i)].append(ms)
                row.append(f"{cases[i][0]} {ms:.4f}")
            print(f"round {r} {name or 'shipped'}: " + ", ".join(row),
                  flush=True)
    use(None)
    for (name, i), xs in times.items():
        if xs:
            print(f"{name or 'shipped'} / {cases[i][0]}: device_ms median "
                  f"{statistics.median(xs):.4f} range [{min(xs):.4f}, "
                  f"{max(xs):.4f}] over {len(xs)} rounds", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

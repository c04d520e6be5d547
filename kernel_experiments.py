#!/usr/bin/env python3
"""Time the key kernel and the three intersect kernels on the calls of real
frames, under measurement builds and launch settings, on one CUDA card.

    python3 kernel_experiments.py
    python3 kernel_experiments.py --frames large,large400_hbm --spp 2
    python3 kernel_experiments.py --kernels keys --variants default,keys_cpt1
    python3 kernel_experiments.py --pkg-root DIR --variants default

Renders each frame once with its intersect calls recorded (the frames of
chip_smoke.py: the 100k-triangle interior under the single-table plan, the
400k-triangle interior under the chunked and the supergroup plan, and with
``--frames box`` the built-in box at 1024 x 1024, spp 16), prepares
every call's kernel inputs once, and then replays one kernel's step alone
over all calls of the frame once per variant, each call timed by CUDA
events with the stream asleep while the host enqueues.  ``--kernels`` names
the steps: ``intersect`` (the intersect wrapper: kernel plus whatever the
wrapper does around it, a sort of the rows in older checkouts) and ``keys``
(the key wrapper as the frame's path calls it; ``ms_mean`` is that launch,
``ms_order_mean`` the whole step up to an ordered candidate list, which
includes ``torch.sort`` where the package sorts outside the kernel).  Prints
one JSON line per (frame, kernel, variant): mean, median, slowest and total
ms, slowest over mean.  The first ``--check`` calls of each frame are also held
exactly equal to the plain version, under every variant that computes
results.  ``--sass FILE`` writes ``cuobjdump -sass`` of the key kernel's
library to FILE (to count the instructions of its inner loop).

Variants, joined by "+" to combine two (each answers what one cause of lost time is worth):

  default        the kernels as built and launched by the package
  skip_tests     built with -DMCPT_SKIP_TESTS: the copy pipeline, barriers
                 and exit alone, no triangle tests (results not checked)
  rays1, rays2   built with -DMCPT_RAYS_PER_THREAD=1 / 2: a staged column is
                 used for 1 or 2 rays per thread instead of 4
  split1         single-table kernel with one block per subtile, however
                 long its candidate list (INTERSECT_SPLIT = 1)
  split16        candidate lists cut over up to 16 blocks
  blocks1, blocks4   built with -DMCPT_MIN_BLOCKS=1 / 4 instead of 3: the
                 compiler takes what registers it likes (2 blocks of 256
                 threads fit an SM), or is capped at 64 a thread (4 blocks)
  lane_cols2, lane_cols8   built with -DMCPT_COLS_PER_LANE=2 / 8 instead of
                 4: on a table narrower than a piece (the box: 16 columns) a
                 lane takes at least that many columns, which sets the block
                 size (128 / 32 threads instead of 64)
  hbm_split1, hbm_split2, hbm_split4, hbm_split8, hbm_split32   supergroup
                 kernel with a subtile's pieces dealt out to 1 / 2 / 4 / 8 /
                 32 blocks instead of 16
  ftb_split2, ftb_split4   chunked kernel with a row's clusters dealt out
                 to 2 / 4 blocks instead of 1
  keys_no_octant   key kernel built with -DMCPT_KEYS_NO_OCTANT: near and far
                 plane by select per pair, as before the octant bodies
  keys_always_repair  built with -DMCPT_KEYS_ALWAYS_REPAIR: selects and the
                 NaN repair on every pair
  keys_cpt1, keys_cpt2  built with -DMCPT_KEYS_CLUSTERS_PER_THREAD=1 / 2
                 instead of 4
  list_unfused   key kernel writes keys, torch.sort orders them
                 (FUSED_SORT_MAX_CLUSTERS = 0: every table counts as past the
                 fused sort's limit)

``--pkg-root DIR`` imports montecarlopathtracing_torch from DIR (a checkout
of another commit), to compare two commits on one card in one call; a
package without a variant's switch skips that variant.  A package from
before the key kernel made the front-to-back list is driven as it was: its
intersect wrappers sort the rows themselves and take no row list.
Imports only torch and montecarlopathtracing_torch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

SLEEP_CYCLES = 2_000_000
MEGA = 16
TILE = 64

FRAMES = {
    # label: (triangles of the interior or 0 for the built-in box at
    # 1024 x 1024, large_mode, the wavefront's intersector to record)
    "box": (0, "hbm", "cluster_intersect"),
    "large": (100_000, "hbm", "cluster_intersect"),
    "large400_chunked": (400_000, "hbm", "cluster_intersect_chunked"),
    "large400_hbm": (400_000, "hbm_always", "cluster_intersect_hbm"),
}

# The source each frame's intersect kernel is built from (its key kernel:
# cluster_keys).
SOURCES = {"box": "cluster_intersect", "large": "cluster_intersect",
           "large400_chunked": "cluster_intersect_ftb",
           "large400_hbm": "cluster_intersect_hbm"}

# variant: (extra nvcc flags, {module switch: value}, results are checked)
VARIANTS = {
    "default": ((), {}, True),
    "skip_tests": (("-DMCPT_SKIP_TESTS",), {}, False),
    "rays1": (("-DMCPT_RAYS_PER_THREAD=1",), {}, True),
    "rays2": (("-DMCPT_RAYS_PER_THREAD=2",), {}, True),
    "blocks4": (("-DMCPT_MIN_BLOCKS=4",), {}, True),
    "split1": ((), {"INTERSECT_SPLIT": 1}, True),
    "split16": ((), {"INTERSECT_SPLIT": 16}, True),
    "blocks1": (("-DMCPT_MIN_BLOCKS=1",), {}, True),
    "lane_cols2": (("-DMCPT_COLS_PER_LANE=2",), {}, True),
    "lane_cols8": (("-DMCPT_COLS_PER_LANE=8",), {}, True),
    "hbm_split1": ((), {"HBM_SPLIT": 1}, True),
    "hbm_split2": ((), {"HBM_SPLIT": 2}, True),
    "hbm_split8": ((), {"HBM_SPLIT": 8}, True),
    "hbm_split4": ((), {"HBM_SPLIT": 4}, True),
    "hbm_split32": ((), {"HBM_SPLIT": 32}, True),
    "ftb_split2": ((), {"FTB_SPLIT": 2}, True),
    "ftb_split4": ((), {"FTB_SPLIT": 4}, True),
    "keys_no_octant": (("-DMCPT_KEYS_NO_OCTANT",), {}, True),
    "keys_always_repair": (("-DMCPT_KEYS_ALWAYS_REPAIR",), {}, True),
    "keys_cpt1": (("-DMCPT_KEYS_CLUSTERS_PER_THREAD=1",), {}, True),
    "keys_cpt2": (("-DMCPT_KEYS_CLUSTERS_PER_THREAD=2",), {}, True),
    "list_unfused": ((), {"FUSED_SORT_MAX_CLUSTERS": 0}, True),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn):
    """(device ms, result) of one call; the stream sleeps first so the host
    has enqueued the call before the start event is stamped."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


class Capture:
    """Records (accel, origin, direction, mt) of every call the wavefront
    makes to the named intersector; calls pass through."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []
        self.inner = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def __call__(self, accel, *args, **kw):
        origin, direction = args[-2:]
        self.calls.append((accel, origin, direction, kw.get("mt", False)))
        return self.inner(accel, *args, **kw)


def prepare(K, label, acc, origin, direction, mt):
    """(kernel launch closure, plain version closure, candidate counts per
    row) on one recorded call's inputs, everything before the intersect
    kernel done once."""
    o, d, _, tile = K._shape_and_pad(origin, direction, TILE, MEGA)
    if label in ("box", "large"):
        rays = K.pack_rays(o, d)
        _, counts, ids = K.cluster_keys(rays, K._caabb(acc.cmin, acc.cmax), tile)
        rays_i = K.pack_rays(o, d, mt=True) if mt else rays
        args = (rays_i, counts, ids, acc.tconst, tile, mt)
        return (lambda: K.cluster_intersect_padded(*args),
                lambda: K.cluster_intersect_padded_plain(*args), counts)
    fused = hasattr(K, "cluster_keys_ftb")  # the key kernel orders and lists
    if label == "large400_chunked":
        cap = K.chunk_caps(acc, o, d)
        rays = K.pack_rays(o, d, mt=mt)
        keys, counts = K.cluster_keys_chunked(rays, cap, acc.caabb, tile)
        order, qkeys = K._ftb_candidates(keys)
        args = (rays, counts, order, qkeys, acc.tconst, tile, mt)
        plain = lambda: K.cluster_intersect_ftb_plain(*args, chunk_cap=cap)
        if not fused:
            return (lambda: K.cluster_intersect_ftb(*args, chunk_cap=cap),
                    plain, counts)
        cand = K.cluster_keys_chunked_ftb(rays, cap, acc.caabb, tile)[2]
        return (lambda: K.cluster_intersect_ftb(
            rays, counts, cand.order, cand.qkeys, acc.tconst, tile, mt,
            chunk_cap=cap, row_list=cand.row_list), plain, counts)
    rays8 = K.pack_rays(o, d)
    keys, counts, _ = K.cluster_keys(rays8, acc.caabb, tile, with_ids=False)
    order, qkeys = K._ftb_candidates(keys)
    rays = K.pack_rays(o, d, mt=True) if mt else rays8
    args = (rays, counts, order, qkeys, acc.tconst, tile, mt)
    plain = lambda: K.cluster_intersect_hbm_plain(*args)
    if not fused:
        return lambda: K.cluster_intersect_hbm_padded(*args), plain, counts
    cand = K.cluster_keys_ftb(rays8, acc.caabb, tile)[2]
    return (lambda: K.cluster_intersect_hbm_padded(
        rays, counts, cand.order, cand.qkeys, acc.tconst, tile, mt,
        row_list=cand.row_list), plain, counts)


def prepare_keys(K, label, acc, origin, direction, mt):
    """(key launch closure, closure of the whole step up to an ordered
    candidate list, check of that step's result against the plain version)
    on one recorded call's inputs."""
    o, d, _, tile = K._shape_and_pad(origin, direction, TILE, MEGA)
    fused = hasattr(K, "cluster_keys_ftb")

    def prefix_equal(counts, a, b):
        used = (torch.arange(a.shape[1], device=a.device)[None, :]
                < counts[:, None])
        return torch.equal(torch.where(used, a, 0), torch.where(used, b, 0))

    if label in ("box", "large"):
        rays = K.pack_rays(o, d)
        caabb = K._caabb(acc.cmin, acc.cmax)
        launch = lambda: K.cluster_keys(rays, caabb, tile)

        def check(got):
            keys, counts, ids = got
            keys_p, counts_p, ids_p = K.cluster_keys_plain(rays, caabb, tile)
            return (torch.equal(keys, keys_p) and torch.equal(counts, counts_p)
                    and prefix_equal(counts, ids, ids_p))
        return launch, launch, check
    if label == "large400_chunked":
        cap = K.chunk_caps(acc, o, d)
        rays = K.pack_rays(o, d, mt=mt)
        plain = lambda: K.cluster_keys_chunked_plain(rays, cap, acc.caabb, tile)
        if fused:
            launch = lambda: K.cluster_keys_chunked_ftb(rays, cap, acc.caabb, tile)
        else:
            launch = lambda: K.cluster_keys_chunked(rays, cap, acc.caabb, tile)
    else:
        rays = K.pack_rays(o, d)
        plain = lambda: K.cluster_keys_plain(rays, acc.caabb, tile)[:2]
        if fused:
            launch = lambda: K.cluster_keys_ftb(rays, acc.caabb, tile)
        else:
            launch = lambda: K.cluster_keys(rays, acc.caabb, tile,
                                            with_ids=False)[:2]
    if fused:
        def step():
            _, counts, cand = launch()
            return counts, cand.order, cand.qkeys
    else:
        def step():
            keys, counts = launch()
            return (counts,) + tuple(K._ftb_candidates(keys))

    def check(got):
        counts, order, qkeys = got
        keys_p, counts_p = plain()
        order_p, qkeys_p = K._ftb_candidates(keys_p)
        return (torch.equal(counts, counts_p)
                and prefix_equal(counts, order, order_p)
                and prefix_equal(counts, qkeys.view(torch.int32),
                                 qkeys_p.view(torch.int32)))
    return launch, step, check


def write_sass(B, dest: str) -> None:
    """cuobjdump -sass of the key kernel's library into the file ``dest``."""
    path = B.build(["cluster_keys"])["cluster_keys"]["path"]
    tool = os.path.join(os.path.dirname(B.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    with open(dest, "w") as fh:
        fh.write(out)


def run_variants(args, B, K, label, kernel, calls, spp) -> None:
    """Replay one kernel's step over a frame's recorded calls, once per
    variant; one JSON line each."""
    extra = {}
    if kernel == "keys":
        prepared = [prepare_keys(K, label, *call) for call in calls]
        src = "cluster_keys"
    else:
        prepared = [prepare(K, label, *call) for call in calls]
        src = SOURCES[label]
        pairs = [int(p[2].sum()) for p in prepared]
        # The longest candidate list of any row, and of the mean call's rows.
        extra = {"pairs_mean": sum(pairs) / len(pairs), "pairs_max": max(pairs),
                 "pairs_max_over_mean": max(pairs) * len(pairs) / sum(pairs),
                 "row_candidates_max": max(int(p[2].max()) for p in prepared),
                 "row_candidates_mean":
                     sum(pairs) / sum(p[2].numel() for p in prepared)}
    for variant in args.variants.split(","):
        flags, switches, checked = (), {}, True
        for part in variant.split("+"):  # "a+b" combines two variants
            f, sw, ch = VARIANTS[part]
            flags, switches, checked = flags + f, {**switches, **sw}, checked and ch
        if (flags and not hasattr(B, "EXTRA_FLAGS")) or any(
                not hasattr(K, k) for k in switches):
            emit({"frame": label, "kernel": kernel, "variant": variant,
                  "skipped": "this package has no such switch", "tag": args.tag})
            continue
        saved = {k: getattr(K, k) for k in switches}
        if hasattr(B, "EXTRA_FLAGS"):
            B.EXTRA_FLAGS = tuple(flags)
            B.load.cache_clear()
        for k, v in switches.items():
            setattr(K, k, v)
        t0 = time.perf_counter()
        prepared[0][1 if kernel == "keys" else 0]()  # build, warm up
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ptxas = [ln.split(":", 1)[-1].strip()
                 for ln in B.build([src])[src]["log"].splitlines()
                 if "registers" in ln]
        ms, ms_order = [], []
        for i, prep in enumerate(prepared):
            if kernel == "keys":
                launch, step, ok = prep
                ms.append(timed(launch)[0])
                t, got = timed(step)
                ms_order.append(t)
                if checked and i < args.check and not ok(got):
                    raise AssertionError(f"{label}/keys/{variant}: call {i} "
                                         "differs from the plain version")
                continue
            launch, plain, _ = prep
            t, got = timed(launch)
            ms.append(t)
            if checked and i < args.check:
                want = plain()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"{label}/{variant}: call {i} differs from the "
                        "plain version")
        for k, v in saved.items():
            setattr(K, k, v)
        mean = sum(ms) / len(ms)
        extra["ms_median"] = sorted(ms)[len(ms) // 2]
        if ms_order:
            extra["ms_order_mean"] = sum(ms_order) / len(ms_order)
        emit({"frame": label, "kernel": kernel, "variant": variant,
              "calls": len(ms), "ms_mean": mean, "ms_max": max(ms),
              "ms_total": sum(ms), "ms_max_over_mean": max(ms) / mean, **extra,
              "checked_calls": min(args.check, len(ms)) if checked else 0,
              "first_call_s": build_s, "ptxas": ptxas, "spp": spp,
              "tag": args.tag})
    if hasattr(B, "EXTRA_FLAGS"):
        B.EXTRA_FLAGS = ()
        B.load.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--frames", default="large,large400_chunked,large400_hbm")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--spp", type=int, default=0,
                    help="samples per pixel (default 16 box, 4 interiors)")
    ap.add_argument("--check", type=int, default=3,
                    help="calls per frame held against the plain version")
    ap.add_argument("--kernels", default="intersect",
                    help="steps to replay: intersect, keys or both (a,b)")
    ap.add_argument("--sass", default="", metavar="FILE",
                    help="write the key kernel's SASS to FILE")
    ap.add_argument("--tag", default="", help="copied into every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_experiments: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.pkg_root))
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator import wavefront
    from montecarlopathtracing_torch.kernels import build as B
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import (load_builtin_box,
                                                           load_builtin_large)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "pkg_root": args.pkg_root,
          "tag": args.tag})
    if args.sass:
        write_sass(B, args.sass)
    scenes = {}
    for label in args.frames.split(","):
        n_tris, mode, name = FRAMES[label]
        if n_tris == 0:
            scenes[0] = load_builtin_box(width=1024, height=1024,
                                         device="cuda")[0]
        elif n_tris not in scenes:
            scenes[n_tris] = load_builtin_large(n_tris=n_tris, width=1280,
                                                height=720, device="cuda")[0]
        spp = args.spp or (4 if n_tris else 16)
        opts = RenderOptions(spp=spp, spp_chunk=spp, large_mode=mode)
        with Capture(wavefront, name) as cap:
            wavefront.render_image_host_chunked(scenes[n_tris], None, opts,
                                                device="cuda")
        torch.cuda.synchronize()
        calls = cap.calls
        del cap
        for kernel in args.kernels.split(","):
            run_variants(args, B, K, label, kernel, calls, spp)
        del calls
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

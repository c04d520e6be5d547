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
includes ``torch.sort`` where the package sorts outside the kernel).  On the
chunked frame ``ms_step_mean`` is the intersect step up to the merged (R,)
result, with the PyTorch merge of the K chunks in a package that runs one:
with ``--pkg-root`` on a checkout from before the chunks met in the join
word, the two ``ms_step_mean`` give that change's worth on one card.  Prints
one JSON line per (frame, kernel, variant): mean, median, slowest and total
ms, slowest over mean.  The first ``--check`` calls of each frame are also held
exactly equal to the plain version, under every variant that computes
results.  ``--sass FILE`` writes ``cuobjdump -sass`` of the key kernel's and
the chunked intersect kernel's libraries to FILE (to count the instructions
of their inner loops); ``--frames ""`` then replays nothing.

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
  keys_no_octant   key kernel built with -DMCPT_KEYS_NO_OCTANT: near and far
                 plane by select per pair, as before the octant bodies
  keys_always_repair  built with -DMCPT_KEYS_ALWAYS_REPAIR: selects and the
                 NaN repair on every pair
  keys_cpt1, keys_cpt2  built with -DMCPT_KEYS_CLUSTERS_PER_THREAD=1 / 2
                 instead of 4
  list_unfused   key kernel writes keys, torch.sort orders them
                 (FUSED_SORT_MAX_CLUSTERS = 0: every table counts as past the
                 fused sort's limit)
  count          chunked kernel built with -DMCPT_COUNT_STATS: blocks that
                 find no row, (ray, triangle) pairs and warp steps that an
                 exact plane-distance reject would decide (COUNTER_NAMES)

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
    "keys_no_octant": (("-DMCPT_KEYS_NO_OCTANT",), {}, True),
    "keys_always_repair": (("-DMCPT_KEYS_ALWAYS_REPAIR",), {}, True),
    "keys_cpt1": (("-DMCPT_KEYS_CLUSTERS_PER_THREAD=1",), {}, True),
    "keys_cpt2": (("-DMCPT_KEYS_CLUSTERS_PER_THREAD=2",), {}, True),
    "list_unfused": ((), {"FUSED_SORT_MAX_CLUSTERS": 0}, True),
    "count": (("-DMCPT_COUNT_STATS",), {}, True),
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


def merged(K, acc, out):
    """A chunked intersect result as one (R,) (t, global tri) pair: as it
    is, or, from a package whose kernel returns (K, R) chunk-local results,
    through the lexicographic merge that package ran after it."""
    bt, bi = out
    if bt.dim() == 1:
        return bt, bi
    hit_k = bi >= 0
    tri_g = torch.where(hit_k, bi + acc.offsets[:, None], 2 ** 31 - 1)
    t_k = torch.where(hit_k, bt, K.BIG)
    best_t = torch.amin(t_k, dim=0)
    best_i = torch.amin(torch.where(t_k == best_t[None], tri_g, 2 ** 31 - 1),
                        dim=0)
    return best_t, torch.where(best_t < K.BIG, best_i, -1)


def prepare(K, label, acc, origin, direction, mt):
    """On one recorded call's inputs, everything before the intersect kernel
    done once: {"launch": kernel launch closure (takes a counter on the
    chunked frame), "plain": plain version closure, "counts": candidate
    counts per row}, and on the chunked frame "listed" (the row list's
    length) and "step" (the launch and whatever merge of the chunks the
    package runs after it, up to the (R,) result)."""
    o, d, _, tile = K._shape_and_pad(origin, direction, TILE, MEGA)
    if label in ("box", "large"):
        rays = K.pack_rays(o, d)
        _, counts, ids = K.cluster_keys(rays, K._caabb(acc.cmin, acc.cmax), tile)
        rays_i = K.pack_rays(o, d, mt=True) if mt else rays
        args = (rays_i, counts, ids, acc.tconst, tile, mt)
        return {"launch": lambda: K.cluster_intersect_padded(*args),
                "plain": lambda: K.cluster_intersect_padded_plain(*args),
                "counts": counts}
    fused = hasattr(K, "cluster_keys_ftb")  # the key kernel orders and lists
    if label == "large400_chunked":
        cap = K.chunk_caps(acc, o, d)
        rays = K.pack_rays(o, d, mt=mt)
        keys, counts = K.cluster_keys_chunked(rays, cap, acc.caabb, tile)
        order, qkeys = K._ftb_candidates(keys)
        args = (rays, counts, order, qkeys, acc.tconst, tile, mt)
        words = "offsets" in K.cluster_intersect_ftb.__code__.co_varnames
        more = {"offsets": acc.offsets} if words else {}
        plain = lambda: K.cluster_intersect_ftb_plain(*args, chunk_cap=cap,
                                                      **more)
        if not fused:
            return {"launch": lambda: K.cluster_intersect_ftb(*args,
                                                              chunk_cap=cap),
                    "plain": plain, "counts": counts}
        cand = K.cluster_keys_chunked_ftb(rays, cap, acc.caabb, tile)[2]

        def launch(counter=None):
            return K.cluster_intersect_ftb(
                rays, counts, cand.order, cand.qkeys, acc.tconst, tile, mt,
                chunk_cap=cap, counter=counter, row_list=cand.row_list, **more)
        return {"launch": launch, "plain": plain, "counts": counts,
                "listed": int(cand.heads.sum()),
                "step": lambda: merged(K, acc, launch())}
    rays8 = K.pack_rays(o, d)
    keys, counts, _ = K.cluster_keys(rays8, acc.caabb, tile, with_ids=False)
    order, qkeys = K._ftb_candidates(keys)
    rays = K.pack_rays(o, d, mt=True) if mt else rays8
    args = (rays, counts, order, qkeys, acc.tconst, tile, mt)
    plain = lambda: K.cluster_intersect_hbm_plain(*args)
    if not fused:
        return {"launch": lambda: K.cluster_intersect_hbm_padded(*args),
                "plain": plain, "counts": counts}
    cand = K.cluster_keys_ftb(rays8, acc.caabb, tile)[2]
    return {"launch": lambda: K.cluster_intersect_hbm_padded(
        rays, counts, cand.order, cand.qkeys, acc.tconst, tile, mt,
        row_list=cand.row_list), "plain": plain, "counts": counts}


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


# Counters of a -DMCPT_COUNT_STATS build of the chunked intersect kernel
# (kCounters of its source): what each slot receives.
COUNTER_NAMES = ("units_tested", "blocks_without_row", "pairs",
                 "pairs_rejectable", "warp_steps", "warp_steps_all_reject")
COUNTERS = len(COUNTER_NAMES)


def count_shares(totals, calls: int):
    """The counters of a frame's calls, summed, and the shares they give."""
    c = dict(zip(COUNTER_NAMES, totals))
    out = {"counts": c,
           "blocks_without_row_per_call": c["blocks_without_row"] / calls}
    for a, b in (("pairs_rejectable", "pairs"),
                 ("warp_steps_all_reject", "warp_steps")):
        out[f"share_{a}"] = c[a] / max(1, c[b])
    return out


def write_sass(B, dest: str) -> None:
    """cuobjdump -sass of the key kernel's and the chunked intersect
    kernel's libraries into the file ``dest``, one after the other."""
    tool = os.path.join(os.path.dirname(B.find_nvcc()), "cuobjdump")
    parts = []
    for src in ("cluster_keys", "cluster_intersect_ftb"):
        path = B.build([src])[src]["path"]
        parts.append(f"// ==== {src}: {os.path.basename(path)}\n")
        parts.append(subprocess.run([tool, "-sass", path], check=True,
                                    capture_output=True, text=True,
                                    timeout=300).stdout)
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    with open(dest, "w") as fh:
        fh.write("".join(parts))


def sass_loops(text: str, top: int = 3):
    """The loops of each function of a ``cuobjdump -sass`` dump: for every
    backward branch, the instructions from its target to it, and their mix
    (float arithmetic, shared loads, spills: STL / LDL, calls).  Per
    function, the ``top`` loops with the most float instructions (the test
    loops) and the function's spills."""
    import re

    out, name, ins = [], None, []

    def close():
        if name is None:
            return
        addr = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (a, op) in enumerate(ins):
            m = re.search(r"\bBRA (?:`\(\.L_x_\d+\)`|0x([0-9a-f]+))", op)
            if m and m.group(1) and int(m.group(1), 16) <= a:
                body = [o for _, o in ins[addr[int(m.group(1), 16)]:i + 1]]
                mix = {k: sum(1 for o in body if re.search(pat, o))
                       for k, pat in (("float", r"\b(FMUL|FADD|FFMA|FSETP|FSEL|FMNMX|MUFU|FCHK)\b"),
                                      ("lds", r"\bLDS"), ("sts", r"\bSTS"),
                                      ("spill", r"\b(STL|LDL)\b"),
                                      ("call", r"\bCALL\b"), ("bar", r"\bBAR\b"))}
                loops.append({"from": hex(int(m.group(1), 16)), "to": hex(a),
                              "instructions": len(body), **mix})
        loops.sort(key=lambda l: -l["float"])
        out.append({"function": name, "instructions": len(ins),
                    "spills": sum(1 for _, o in ins if re.search(r"\b(STL|LDL)\b", o)),
                    "loops": loops[:top]})

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    close()
    return out


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
        pairs = [int(p["counts"].sum()) for p in prepared]
        rows = [p["counts"].numel() for p in prepared]
        # The longest candidate list of any row, and of the mean call's rows.
        extra = {"pairs_mean": sum(pairs) / len(pairs), "pairs_max": max(pairs),
                 "pairs_max_over_mean": max(pairs) * len(pairs) / sum(pairs),
                 "row_candidates_max": max(int(p["counts"].max())
                                           for p in prepared),
                 "row_candidates_mean": sum(pairs) / sum(rows),
                 "rows_mean": sum(rows) / len(rows)}
        if "listed" in prepared[0]:  # the row list's length, per call
            listed = [p["listed"] for p in prepared]
            extra["listed_rows_mean"] = sum(listed) / len(listed)
            extra["listed_rows_max"] = max(listed)
    for variant in args.variants.split(","):
        flags, switches, checked = (), {}, True
        for part in variant.split("+"):  # "a+b" combines two variants
            f, sw, ch = VARIANTS[part]
            flags, switches, checked = flags + f, {**switches, **sw}, checked and ch
        if (flags and not hasattr(B, "EXTRA_FLAGS")) or any(
                not hasattr(K, k) for k in switches) or (
                "-DMCPT_COUNT_STATS" in flags
                and (kernel != "intersect" or label != "large400_chunked")):
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
        if kernel == "keys":  # build, warm up
            prepared[0][1]()
        else:
            prepared[0]["launch"]()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ptxas = [ln.split(":", 1)[-1].strip()
                 for ln in B.build([src])[src]["log"].splitlines()
                 if "registers" in ln]
        ms, ms_order, ms_step = [], [], []
        counting = "-DMCPT_COUNT_STATS" in flags
        totals = torch.zeros(COUNTERS, dtype=torch.int64)
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
            launch, plain = prep["launch"], prep["plain"]
            if counting:
                ctr = torch.zeros(COUNTERS, dtype=torch.int64, device="cuda")
                t, got = timed(lambda: launch(ctr))
                totals += ctr.cpu()
            else:
                t, got = timed(launch)
            ms.append(t)
            if "step" in prep:
                ms_step.append(timed(prep["step"])[0])
            if checked and i < args.check:
                want = plain()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"{label}/{variant}: call {i} differs from the "
                        "plain version")
        for k, v in saved.items():
            setattr(K, k, v)
        more = dict(extra, ms_median=sorted(ms)[len(ms) // 2])
        if counting:
            more.update(count_shares(totals.tolist(), len(ms)))
        if ms_order:
            more["ms_order_mean"] = sum(ms_order) / len(ms_order)
        if ms_step:
            more["ms_step_mean"] = sum(ms_step) / len(ms_step)
        mean = sum(ms) / len(ms)
        emit({"frame": label, "kernel": kernel, "variant": variant,
              "calls": len(ms), "ms_mean": mean, "ms_max": max(ms),
              "ms_total": sum(ms), "ms_max_over_mean": max(ms) / mean, **more,
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
                    help="write the key and chunked intersect kernels' SASS "
                         "to FILE")
    ap.add_argument("--sass-report", default="", metavar="FILE",
                    help="print the loops of each function of a SASS dump "
                         "(from --sass) and exit; runs without a card")
    ap.add_argument("--tag", default="", help="copied into every line")
    args = ap.parse_args(argv)
    if args.sass_report:  # reads a dump written by --sass; needs no card
        for fn in sass_loops(open(args.sass_report).read()):
            emit(fn)
        return 0
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
    for label in filter(None, args.frames.split(",")):
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

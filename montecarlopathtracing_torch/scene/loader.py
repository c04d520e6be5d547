"""Host-side scene ingest: ``.obj`` / ``.mtl`` / ``.camera`` -> SceneArrays.

Reference parsers: ``MTPC/sceneManagement.cpp:17-74`` (MTL), ``:76-189`` (OBJ),
``:191-262`` (.camera).  Differences by design (SURVEY.md §2.1 / quirk #13):

* The reference denormalizes per-face vertex data at parse time; we parse into
  index buffers and denormalize once, vectorized, when building device arrays.
* The reference reads face corners in ``v/vn/vt`` order — the *reverse* of the
  OBJ standard (``v/vt/vn``).  Benign for the shipped scenes (all three indices
  identical per corner); this parser is standard-compliant.
* OpenCV texture decode (``Material::readinMap``, MTPC/sceneManagement.h:134-143,
  BGR) is replaced by the port's own PNG decoder (``film.read_png``) for
  ``.png`` files and by PIL (RGB) for every other format.
* Faces with >3 corners are fan-triangulated (the reference would mis-parse them).

Counterpart of ``montecarlopathtracing_tpu/scene/loader.py``.  The host part
is the same numpy, kept bit-identical: the triangle order becomes the cluster
ids, so any drift would change hit triangle ids and tie-breaking.  Only the
final upload differs (``torch.as_tensor`` onto ``device``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import RenderOptions
from ..film.film import read_png
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from ..utils.timing import span
from .types import CameraArrays, SceneArrays, SceneMeta, pad_pow2

log = get_logger(__name__)

BIG = np.float32(1e30)  # empty-AABB sentinel; finite to avoid inf*0 NaNs


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes_np(points: np.ndarray, compat_bounds: bool = True) -> np.ndarray:
    """NumPy twin of ops.morton.morton_codes (host-side, used at load time)."""
    points = np.asarray(points, np.float64)
    if compat_bounds:
        lo, hi = -1.0, 4.0  # MTPC/morton code.h:6-7
        normalized = (points - lo) / (hi - lo)
    else:
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        normalized = (points - lo) / np.maximum(hi - lo, 1e-20)
    # float32 quantization matches getMortonCode's float math
    # (MTPC/morton code.cpp:12-21).
    q = np.clip(normalized.astype(np.float32) * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        _expand_bits_np(q[:, 0]) * np.uint32(4)
        + _expand_bits_np(q[:, 1]) * np.uint32(2)
        + _expand_bits_np(q[:, 2])
    )


def _median_cluster_order(tmin: np.ndarray, tmax: np.ndarray, width: int
                          ) -> np.ndarray:
    """Triangle permutation from a recursive best-axis median split.

    The cluster intersector slices the triangle order into fixed ``width``
    runs (kernels/cluster.py); the run AABBs are what cull candidates, so the
    ORDER is the acceleration structure.  Fixed-width Morton runs inherit
    whatever a Morton range straddles; this build instead splits the set
    top-down — at each node trying all three axes (sorted by AABB-center) and
    keeping the one minimizing the children's summed half-surface-areas — and
    emits leaves in DFS order.  Split indices are WIDTH-ALIGNED on the left
    child, so every leaf is exactly ``width`` triangles except the global
    tail: the order needs no interior padding slots.

    Pure host NumPy, O(N log^2 N); runs once at scene load (the reference
    builds its LBVH once on load too, MTPC/MTPC.cpp:44-47).
    """
    n = tmin.shape[0]
    center = (tmin + tmax) * 0.5
    out = np.empty(n, np.int64)
    out_pos = 0
    # Explicit stack of index arrays (DFS, left first).
    stack: list = [np.arange(n, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        m = idx.shape[0]
        if m <= width:
            out[out_pos:out_pos + m] = idx
            out_pos += m
            continue
        if m > 8192:
            # Top levels: leaf tightness is decided far below, so an O(m)
            # largest-extent-axis split at the aligned median (argpartition,
            # no full sort) keeps 1M+ triangle builds in seconds; the 3-axis
            # SAH sweep below is where cluster AABB quality comes from.
            ax = int(np.argmax(center[idx].max(axis=0) - center[idx].min(axis=0)))
            left = int(np.clip(round(m / 2 / width) * width, width,
                               ((m - 1) // width) * width))
            part = idx[np.argpartition(center[idx, ax], left - 1)]
            stack.append(part[left:])
            stack.append(part[:left])
            continue
        best = None
        for ax in range(3):
            order = np.argsort(center[idx, ax], kind="stable")
            s = idx[order]
            # Surface-area sweep over all width-aligned split positions
            # (left size a multiple of width, both children nonempty):
            # prefix/suffix running AABBs give every split's
            # SA(L)*nL + SA(R)*nR in O(m).
            pre_min = np.minimum.accumulate(tmin[s], axis=0)
            pre_max = np.maximum.accumulate(tmax[s], axis=0)
            suf_min = np.minimum.accumulate(tmin[s][::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(tmax[s][::-1], axis=0)[::-1]

            def sa(lo, hi):
                e = hi - lo
                return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 0] * e[:, 2]

            lefts = np.arange(width, ((m - 1) // width) * width + 1, width)
            cost = (sa(pre_min[lefts - 1], pre_max[lefts - 1]) * lefts
                    + sa(suf_min[lefts], suf_max[lefts]) * (m - lefts))
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), s, int(lefts[k]))
        _, s, left = best
        stack.append(s[left:])   # popped after the left child (DFS order)
        stack.append(s[:left])
    return out


class MaterialRecord:
    __slots__ = ("name", "kd", "ks", "ns", "ni", "map_kd")

    def __init__(self, name: str):
        self.name = name
        self.kd = np.zeros(3)
        self.ks = np.zeros(3)
        self.ns = 1.0
        self.ni = 1.0
        self.map_kd: Optional[str] = None


def parse_mtl(path: str) -> List[MaterialRecord]:
    """newmtl/Kd/Ks/Ns/Ni/map_Kd, same keys as MTPC/sceneManagement.cpp:17-74."""
    materials: List[MaterialRecord] = []
    cur: Optional[MaterialRecord] = None
    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            key = tok[0]
            if key == "newmtl":
                cur = MaterialRecord(raw.split(None, 1)[1].strip())
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = np.array([float(x) for x in tok[1:4]])
            elif key == "Ks":
                cur.ks = np.array([float(x) for x in tok[1:4]])
            elif key == "Ns":
                cur.ns = float(tok[1])
            elif key == "Ni":
                cur.ni = float(tok[1])
            elif key == "map_Kd":
                cur.map_kd = raw.split(None, 1)[1].strip()
    return materials


def parse_obj(path: str, material_index: Dict[str, int]):
    """v/vn/vt/usemtl/f -> index buffers (standard corner order v/vt/vn)."""
    vs: List[Tuple[float, float, float]] = []
    vns: List[Tuple[float, float, float]] = []
    vts: List[Tuple[float, float]] = []
    face_v: List[Tuple[int, int, int]] = []
    face_vn: List[Tuple[int, int, int]] = []
    face_vt: List[Tuple[int, int, int]] = []
    face_mat: List[int] = []
    cur_mat = 0

    def corner(tok: str) -> Tuple[int, int, int]:
        parts = tok.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        # OBJ is 1-based; negative indices count from the end.
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ti - 1 if ti > 0 else (len(vts) + ti if ti < 0 else -1)
        ni = ni - 1 if ni > 0 else (len(vns) + ni if ni < 0 else -1)
        return vi, ti, ni

    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            key = tok[0]
            if key == "v":
                vs.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vn":
                vns.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vt":
                vts.append((float(tok[1]), float(tok[2])))
            elif key == "usemtl":
                cur_mat = material_index.get(raw.split(None, 1)[1].strip(), 0)
            elif key == "f":
                corners = [corner(t) for t in tok[1:]]
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri = (corners[0], corners[k], corners[k + 1])
                    face_v.append(tuple(c[0] for c in tri))
                    face_vt.append(tuple(c[1] for c in tri))
                    face_vn.append(tuple(c[2] for c in tri))
                    face_mat.append(cur_mat)

    return (
        np.asarray(vs, np.float64).reshape(-1, 3),
        np.asarray(vns, np.float64).reshape(-1, 3),
        np.asarray(vts, np.float64).reshape(-1, 2),
        np.asarray(face_v, np.int64).reshape(-1, 3),
        np.asarray(face_vt, np.int64).reshape(-1, 3),
        np.asarray(face_vn, np.int64).reshape(-1, 3),
        np.asarray(face_mat, np.int64).reshape(-1),
    )


def parse_camera(path: str):
    """eye/lookat/up/fovy/width/height + `mtlname <name> r g b` light lines
    (MTPC/sceneManagement.cpp:191-262)."""
    cam = dict(eye=(0, 0, 0), lookat=(0, 0, 1), up=(0, 1, 0), fovy=45.0, width=64, height=64)
    lights: List[Tuple[str, Tuple[float, float, float]]] = []
    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            key = tok[0]
            if key in ("eye", "lookat", "up"):
                cam[key] = tuple(float(x) for x in tok[1:4])
            elif key == "fovy":
                cam["fovy"] = float(tok[1])
            elif key == "width":
                cam["width"] = int(tok[1])
            elif key == "height":
                cam["height"] = int(tok[1])
            elif key == "mtlname":
                lights.append((tok[1], tuple(float(x) for x in tok[2:5])))
    return cam, lights


def _load_texture(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) f32 RGB in [0, 1], or None for a file that is missing or
    cannot be decoded here.  A PNG is decoded by ``read_png`` on every
    machine (the JAX package's PIL gives the same values: PNG is lossless);
    another format, or a PNG variant ``read_png`` does not read, needs PIL,
    and without it the texture is dropped with a warning."""
    if not os.path.exists(path):
        return None
    if path.lower().endswith(".png"):
        try:
            return read_png(path).astype(np.float32) / 255.0
        except ValueError:
            pass  # palette, grey, 16-bit or interlaced: PIL reads those
    try:
        from PIL import Image
    except ImportError:
        log.warning("texture %s dropped: decoding it needs PIL, which is not "
                    "installed; the material renders with its kd alone", path)
        return None
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0  # (H,W,3) RGB in [0,1]


def triangle_areas(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """0.5*|cross| — equal to the reference's law-of-cosines formula
    (Face::calAera, MTPC/sceneManagement.cpp:399-406) but numerically stable."""
    return 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)


def build_scene(
    scene_dir: str,
    name: str,
    options: Optional[RenderOptions] = None,
    parsed=None,
    device=None,
) -> Tuple[SceneArrays, SceneMeta]:
    """read_scene equivalent (MTPC/sceneManagement.cpp:264-274): parse the three
    files, order faces into clusters, pack SoA tensors on ``device`` (None =
    the card).

    ``parsed`` optionally injects pre-parsed host data (used by
    ``scene.builtin.load_builtin_large``).  The parse, the host-side build
    and the upload are three spans, ``parse``, ``build`` and ``upload``.
    """
    device = resolve_device(device)
    options = options or RenderOptions()
    base = os.path.join(scene_dir, name)

    if parsed is None:
        with span("parse") as sp:
            materials = parse_mtl(base + ".mtl")
            mat_index = {m.name: i for i, m in enumerate(materials)}
            vs, vns, vts, f_v, f_vt, f_vn, f_mat = parse_obj(base + ".obj",
                                                             mat_index)
            cam, light_list = parse_camera(base + ".camera")
            sp.note(faces=len(f_mat))
    else:
        materials, mat_index, (vs, vns, vts, f_v, f_vt, f_vn, f_mat), cam, light_list = parsed

    # Closed by hand before the upload: the build is too long to indent
    # under a ``with``.
    build = span("build")
    build.__enter__()

    if not materials:
        materials = [MaterialRecord("default")]
        materials[0].kd = np.array([0.8, 0.8, 0.8])
        mat_index = {"default": 0}

    num_faces = len(f_mat)
    if num_faces == 0:
        raise ValueError(f"scene '{name}' has no faces")

    # Denormalize (gather indices -> per-face corner data) in one vectorized shot.
    p0, p1, p2 = vs[f_v[:, 0]], vs[f_v[:, 1]], vs[f_v[:, 2]]
    if len(vns):
        nn0, nn1, nn2 = (np.where(f_vn[:, [k]] >= 0, vns[np.maximum(f_vn[:, k], 0)], 0.0) for k in range(3))
    else:
        nn0 = nn1 = nn2 = np.zeros_like(p0)
    if len(vts):
        t0, t1, t2 = (np.where(f_vt[:, [k]] >= 0, vts[np.maximum(f_vt[:, k], 0)], 0.0) for k in range(3))
    else:
        t0 = t1 = t2 = np.zeros((num_faces, 2))

    # Geometric normal exactly as Face::calNorm (MTPC/sceneManagement.cpp:408-412):
    # (v1-v2) x (v3-v1), normalized.
    gn = np.cross(p0 - p1, p2 - p0)
    gn_len = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = gn / np.maximum(gn_len, 1e-30)
    # Missing vn entries fall back to the geometric normal.
    for arr, idx in ((nn0, 0), (nn1, 1), (nn2, 2)):
        missing = (f_vn[:, idx] < 0) if len(vns) else np.ones(num_faces, bool)
        arr[missing] = gn[missing]

    # Morton order over centroids (MTPC/sceneManagement.cpp:176-179 + sort at
    # MTPC/MTPC.cpp:44), with one TPU-motivated refinement: triangles whose
    # own AABB is a large fraction of the scene (walls, floors — e.g. the 14
    # full-wall quads of cornell-box) are segregated to the front.  A Morton
    # range that mixes one wall triangle with furniture gets a near-scene-
    # sized bounding box, which defeats the cluster intersector's culling —
    # measured: 10 of 13 average candidate clusters per ray subtile were
    # such bloated boxes.  Segregation is estimator-neutral (triangle order
    # only affects equal-t tie-breaking, and the oracle shares these arrays).
    centroids = (p0 + p1 + p2) / 3.0
    codes = morton_codes_np(centroids, compat_bounds=options.compat.hardcoded_morton_bounds)
    ext = np.maximum(np.maximum(p0, p1), p2) - np.minimum(np.minimum(p0, p1), p2)
    tri_sa = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2]
    scene_ext = (np.maximum(np.maximum(p0, p1), p2).max(axis=0)
                 - np.minimum(np.minimum(p0, p1), p2).min(axis=0))
    scene_sa = (scene_ext[0] * scene_ext[1] + scene_ext[1] * scene_ext[2]
                + scene_ext[0] * scene_ext[2])
    big = tri_sa > 0.005 * max(scene_sa, 1e-30)
    # Order at the width the intersector will ACTUALLY slice: scenes past
    # the fine-width VMEM budget run width-128 clusters (wavefront.
    # _cluster_plan), and split positions aligned to the requested 32 leave
    # width-128 clusters straddling split boundaries — measured 21-45
    # candidate clusters per active subtile on the 400k-tri interior vs 5.3
    # on cornell.  The byte model mirrors _cluster_plan/_tconst_bytes_per_tri.
    w = max(1, options.cluster_width)
    if num_faces * 16 * max(w, 128) * 4 // w > (10 << 20):
        w = 128
    use_median = (getattr(options, "cluster_order", "morton_gap") == "median"
                  and num_faces > w)
    if use_median:
        # Best-axis median-split order (see _median_cluster_order), big
        # triangles still segregated to the front as their own subtree.
        tmin_all = np.minimum(np.minimum(p0, p1), p2)
        tmax_all = np.maximum(np.maximum(p0, p1), p2)
        parts = []
        for grp in (np.nonzero(big)[0], np.nonzero(~big)[0]):
            if len(grp):
                parts.append(grp[_median_cluster_order(
                    tmin_all[grp], tmax_all[grp], w)])
        order = np.concatenate(parts)
    else:
        order = np.lexsort((np.arange(num_faces), codes, (~big).astype(np.int8)))

    p0, p1, p2 = p0[order], p1[order], p2[order]
    nn0, nn1, nn2 = nn0[order], nn1[order], nn2[order]
    t0, t1, t2 = t0[order], t1[order], t2[order]
    gn = gn[order]
    f_mat = f_mat[order]

    # Cluster-boundary gap padding: the TPU intersector cuts the Morton order
    # into fixed ``cluster_width`` runs; a run that straddles a large Morton
    # discontinuity (or the big-triangle frontier) inherits a bloated AABB
    # that defeats culling.  Insert invalid padding slots so that every
    # position where consecutive codes differ above bit ``cluster_gap_bits``
    # starts a fresh width-aligned run.  Estimator-neutral except for
    # equal-t tie-breaking between coincident triangles (same class of
    # divergence as the big-triangle segregation above, see docs/COMPAT.md).
    gap_bits = getattr(options, "cluster_gap_bits", 0)
    if use_median or (gap_bits and num_faces > w):
        if use_median:
            # Median-split leaves are width-aligned by construction; the only
            # boundary needing padding is the big/rest group frontier.
            cut = big[order][1:] != big[order][:-1]
        else:
            x = codes[order][1:] ^ codes[order][:-1]
            cut = x >= (1 << gap_bits)
            cut |= big[order][1:] != big[order][:-1]
        starts = np.concatenate([[0], np.nonzero(cut)[0] + 1, [num_faces]])
        new_pos = np.empty(num_faces, np.int64)
        fill_pos = 0
        for a, b in zip(starts[:-1], starts[1:]):
            new_pos[a:b] = fill_pos + np.arange(b - a)
            fill_pos += -(-(b - a) // w) * w
        t_new = int(fill_pos)
    else:
        new_pos = np.arange(num_faces)
        t_new = num_faces

    # Pad to a power of two (perfect implicit-heap LBVH, SURVEY.md §7 step 2).
    tpad = pad_pow2(t_new)

    def pad3(a, fill=0.0):
        out = np.full((tpad,) + a.shape[1:], fill, np.float32)
        out[new_pos] = a
        return out

    mat_id = np.zeros(tpad, np.int32)
    mat_id[new_pos] = f_mat
    tri_valid = np.zeros(tpad, bool)
    tri_valid[new_pos] = True
    # Parse-order key per padded slot (gaps get a huge sentinel), used below
    # for the parse-order light CDFs.
    order_padded = np.full(tpad, np.iinfo(np.int64).max)
    order_padded[new_pos] = order

    # Material table.
    num_mat = len(materials)
    kd = np.stack([m.kd for m in materials]).astype(np.float32)
    ks = np.stack([m.ks for m in materials]).astype(np.float32)
    ns = np.array([m.ns for m in materials], np.float32)
    ni = np.array([m.ni for m in materials], np.float32)

    # Texture atlas: concatenated flattened (h*w, 3) blocks.
    has_tex = np.zeros(num_mat, bool)
    tex_off = np.zeros(num_mat, np.int32)
    tex_h = np.ones(num_mat, np.int32)
    tex_w = np.ones(num_mat, np.int32)
    blocks: List[np.ndarray] = []
    offset = 0
    for i, m in enumerate(materials):
        if m.map_kd is None:
            continue
        img = _load_texture(os.path.join(scene_dir, m.map_kd))
        if img is None:
            continue
        has_tex[i] = True
        tex_off[i] = offset
        tex_h[i], tex_w[i] = img.shape[0], img.shape[1]
        blocks.append(img.reshape(-1, 3))
        offset += img.shape[0] * img.shape[1]
    # Untextured scenes get a (0, 3) atlas: the EMPTY shape is the static
    # no-texture signal (a legitimate 1x1 texture would make shape (1, 3)).
    atlas = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 3), np.float32)

    # Lights: radiance table + per-light face lists with cumulative-area CDFs
    # (the reference rebuilds this CDF every shade call, MTPC/pathTracing.cpp:177-184;
    # it is a pure function of geometry so we precompute it once).
    emission = np.zeros((num_mat, 3), np.float32)
    is_emitter = np.zeros(num_mat, bool)
    light_names = [ln for ln, _ in light_list]
    light_mat = np.array([mat_index.get(ln, -1) for ln, _ in light_list], np.int32)
    keep = light_mat >= 0
    light_mat = light_mat[keep]
    light_rad = np.array([r for (_, r), k in zip(light_list, keep) if k], np.float32).reshape(-1, 3)
    num_lights = len(light_mat)
    for li in range(num_lights):
        emission[light_mat[li]] = light_rad[li]
        is_emitter[light_mat[li]] = True

    areas_all = triangle_areas(pad3(p0), pad3(p1), pad3(p2))
    fmax = 1
    per_light_faces: List[np.ndarray] = []
    for li in range(num_lights):
        # Indices are PADDED triangle ids (the gap-padded layout above).
        idx = np.nonzero((mat_id == light_mat[li]) & tri_valid)[0]
        # PARSE-order CDF: the reference walks material_map[name]->f, filled
        # during read_obj BEFORE the Morton sort (MTPC/sceneManagement.cpp:
        # 182 vs MTPC/MTPC.cpp:44) — with the frozen-range pick (quirk #4)
        # only the first [0, A_first) of this ordering is ever sampled, so
        # the ordering is observable.
        idx = idx[np.argsort(order_padded[idx], kind="stable")]
        per_light_faces.append(idx)
        fmax = max(fmax, len(idx))
    # Zero-face lights (a camera-file light whose material no triangle uses)
    # keep a -1 row: -1 never equals a real hit triangle id, so the
    # light-face MEMBERSHIP visibility test (wavefront._nee_resolve) stays
    # false — an all-zero row would falsely count triangle 0 as a light face.
    light_face_tri = np.full((max(num_lights, 1), fmax), -1, np.int32)
    light_face_cum = np.full((max(num_lights, 1), fmax), np.float32(1.0))
    light_total = np.ones(max(num_lights, 1), np.float32)
    for li in range(num_lights):
        idx = per_light_faces[li]
        if len(idx) == 0:
            continue
        cum = np.cumsum(areas_all[idx]).astype(np.float32)
        total = cum[-1]
        light_face_tri[li, : len(idx)] = idx
        light_face_tri[li, len(idx):] = idx[-1]
        light_face_cum[li, : len(idx)] = cum
        light_face_cum[li, len(idx):] = total
        light_total[li] = total

    # Scene-extent contract for the cluster kernel's parked-ray skip: parked
    # rays sit at origin 1e9 and both Pallas kernels classify a subtile as
    # all-parked via min(origin.x) > 5e8 (kernels/cluster.py).  Geometry or a
    # camera eye beyond 5e8 would silently drop intersections, so reject it
    # here at load time (every reference-class scene is within a few hundred
    # units; 1e8 leaves a 5x margin).
    _extent = max(
        float(np.max(np.abs(np.concatenate([p0, p1, p2])))) if len(p0) else 0.0,
        float(np.max(np.abs(np.asarray(cam["eye"], np.float32)))),
    )
    if _extent > 1e8:
        raise ValueError(
            f"scene extent {_extent:.3g} exceeds the 1e8 bound required by "
            "the parked-ray sentinel (origin 1e9, all-parked threshold 5e8) "
            "in kernels/cluster.py")

    padded = {k: pad3(a) for k, a in (
        ("v0", p0), ("v1", p1), ("v2", p2), ("n0", nn0), ("n1", nn1),
        ("n2", nn2), ("uv0", t0), ("uv1", t1), ("uv2", t2), ("geom_n", gn))}
    build.__exit__(None, None, None)

    def up(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    with span("upload"):
        camera = CameraArrays(
            eye=up(cam["eye"], np.float32),
            look_at=up(cam["lookat"], np.float32),
            up=up(cam["up"], np.float32),
            fovy=up(cam["fovy"], np.float32),
            width=int(cam["width"]),
            height=int(cam["height"]),
        )
        scene = SceneArrays(
            **{k: up(a) for k, a in padded.items()},
            mat_id=up(mat_id),
            tri_valid=up(tri_valid),
            kd=up(kd), ks=up(ks), ns=up(ns), ni=up(ni),
            emission=up(emission),
            is_emitter=up(is_emitter),
            has_texture=up(has_tex),
            tex_offset=up(tex_off), tex_h=up(tex_h), tex_w=up(tex_w),
            atlas=up(atlas),
            light_mat=up(light_mat.reshape(-1) if num_lights else np.zeros(0, np.int32)),
            light_radiance=up(light_rad if num_lights else np.zeros((0, 3), np.float32)),
            light_face_tri=up(light_face_tri[:num_lights] if num_lights else np.zeros((0, fmax), np.int32)),
            light_face_cum_area=up(light_face_cum[:num_lights] if num_lights else np.zeros((0, fmax), np.float32)),
            light_total_area=up(light_total[:num_lights] if num_lights else np.zeros(0, np.float32)),
            camera=camera,
        )
    meta = SceneMeta(
        name=name,
        material_names=[m.name for m in materials],
        light_names=light_names,
        num_vertices=len(vs),
        num_faces=num_faces,
        obj_path=base + ".obj",
    )
    return scene, meta

"""NumPy float64 oracle: an independent re-derivation of the reference
integrator's semantics (SURVEY.md §4.2), for both compat mode (the default
quirk set) and MODERN mode (every CompatOptions fix flag).

Counterpart of ``montecarlopathtracing_tpu/oracle/cpu_reference.py``, the
same scalar-math NumPy estimator of ``MTPC/pathTracing.cpp`` (shade
:137-266, nextRay :66-134, generateImg :274-331), keyed to this package's
``integrator/rng.py`` (bitwise equal to the JAX package's), whose uniforms
are converted to NumPy.  Because the oracle and the renderer see identical
random numbers and identical compat semantics, the port's f32 render must
match this f64 render to float32 tolerance, a far stronger check than
statistical agreement, and it gives the port a reference that does not go
through the JAX package.

Intersection is brute force (every triangle) so the oracle is independent of
the LBVH and the cluster tables as well.  Use on tiny scenes only; the scene
may live on any device (its tensors are copied to the host).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RenderOptions
from ..integrator import rng

PI = np.pi


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _np(scene):
    """Materialize scene arrays as float64 numpy."""
    g = lambda a: np.asarray(_host(a), np.float64)
    return {
        "v0": g(scene.v0), "v1": g(scene.v1), "v2": g(scene.v2),
        "n0": g(scene.n0), "n1": g(scene.n1), "n2": g(scene.n2),
        "uv0": g(scene.uv0), "uv1": g(scene.uv1), "uv2": g(scene.uv2),
        "geom_n": g(scene.geom_n),
        "mat_id": _host(scene.mat_id), "tri_valid": _host(scene.tri_valid),
        "kd": g(scene.kd), "ks": g(scene.ks), "ns": g(scene.ns), "ni": g(scene.ni),
        "emission": g(scene.emission), "is_emitter": _host(scene.is_emitter),
        "has_texture": _host(scene.has_texture),
        "tex_offset": _host(scene.tex_offset),
        "tex_h": _host(scene.tex_h), "tex_w": _host(scene.tex_w),
        "atlas": g(scene.atlas),
        "light_mat": _host(scene.light_mat),
        "light_radiance": g(scene.light_radiance),
        "light_face_tri": _host(scene.light_face_tri),
        "light_face_cum": g(scene.light_face_cum_area),
        "light_total": g(scene.light_total_area),
    }


def _intersect_brute(s, o, d, compat: bool = True):
    """Nearest hit, f64, vectorized rays x tris.  compat=True: the reference's
    plane+sign test; compat=False: Moller-Trumbore (modern mode, twin of
    ops.intersect.ray_triangle_mt)."""
    p0, p1, p2, gn = s["v0"], s["v1"], s["v2"], s["geom_n"]
    # Both tests are evaluated through per-triangle constants so every term
    # is a (R,3)@(3,T) BLAS matmul — no (R,T,3) f64 temporaries (those made
    # the old einsum/cross form memory-bound, ~20x slower at veach scale).
    # Algebraically identical predicates (cross(a, p-b).n == (p-b).(n x a)),
    # f64 throughout; only ~1e-16-scale rounding differs from the literal
    # cross-product form, far below every oracle tolerance.
    with np.errstate(divide="ignore", invalid="ignore"):
        if compat:
            denom = d @ gn.T                                    # n.d  (R,T)
            t = ((p0 * gn).sum(1)[None] - o @ gn.T) / denom     # plane solve
            cs = []
            for a, b in ((p1 - p0, p0), (p2 - p1, p1), (p0 - p2, p2)):
                m = np.cross(gn, a)                             # (T,3) const
                k = (b * m).sum(1)                              # (T,)
                cs.append(o @ m.T + t * (d @ m.T) - k[None])    # (R,T)
            c1, c2, c3 = cs
            hit = (c1 * c2 >= 0) & (c1 * c3 >= 0) & (c2 * c3 >= 0)
        else:
            e1, e2 = p1 - p0, p2 - p0
            n_raw = np.cross(e1, e2)                            # (T,3)
            ku = np.cross(p0, e2)
            kv = np.cross(e1, p0)
            w = np.cross(o, d)                                  # (R,3)
            det = -(d @ n_raw.T)
            inv_det = 1.0 / det
            t = (o @ n_raw.T - (p0 * n_raw).sum(1)[None]) * inv_det
            u = (w @ e2.T + d @ ku.T) * inv_det
            v = (-(w @ e1.T) + d @ kv.T) * inv_det
            hit = (u >= 0) & (v >= 0) & (u + v <= 1)
    hit &= np.isfinite(t) & (t > 0) & s["tri_valid"][None]
    t = np.where(hit, t, np.inf)
    tri = np.argmin(t, axis=1)
    tbest = t[np.arange(len(o)), tri]
    return np.isfinite(tbest), np.where(np.isfinite(tbest), tbest, 1e30), \
        np.where(np.isfinite(tbest), tri, -1)


def _bary(p, p0, p1, p2):
    e1, e2, e3 = p2 - p1, p0 - p2, p1 - p0
    n = np.cross(e1, e2)
    an = np.einsum("rd,rd->r", n, n)
    b0 = np.einsum("rd,rd->r", np.cross(e1, p - p2), n) / an
    b1 = np.einsum("rd,rd->r", np.cross(e2, p - p0), n) / an
    b2 = np.einsum("rd,rd->r", np.cross(e3, p - p1), n) / an
    return np.stack([b0, b1, b2], -1)


def _norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-300)


def _lobe_frame(axis):
    ax, ay, az = axis[:, 0], axis[:, 1], axis[:, 2]
    use_x = np.abs(ax) > np.abs(ay)
    front = np.where(use_x[:, None],
                     np.stack([az, np.zeros_like(ax), -ax], -1),
                     np.stack([np.zeros_like(ax), -az, ay], -1))
    front = _norm(front)
    right = np.cross(axis, front)
    return right, axis, front


def oracle_render_pixels(scene, opts: RenderOptions, pixel_ids) -> np.ndarray:
    """Mean radiance (R,3) float64 over opts.spp samples.

    Supports every CompatOptions flag combination (compat defaults AND the
    MODERN fix set), consuming the exact same uniform stream as the device
    integrator in either mode.
    """
    s = _np(scene)
    cam = scene.camera
    r_count = len(pixel_ids)
    num_lights = int(s["light_mat"].shape[0])
    n_slots = rng.n_bounce_slots(num_lights)

    # camera (f64 twin of integrator/camera.py)
    eye = np.asarray(_host(cam.eye), np.float64)
    up = _norm(np.asarray(_host(cam.up), np.float64)[None])[0]
    view = np.asarray(_host(cam.look_at), np.float64) - eye
    l = np.linalg.norm(view)
    dy = np.tan(float(_host(cam.fovy)) / 2 / 180 * PI) * l
    dx = dy / cam.height * cam.width
    pdx, pdy = 2 * dx / cam.width, 2 * dy / cam.height
    x_dir = _norm(np.cross(view, up)[None])[0]
    start = np.asarray(_host(cam.look_at), np.float64) - x_dir * dx + up * dy
    pixel_ids = np.asarray(_host(pixel_ids))
    ii = (pixel_ids // cam.width).astype(np.float64)
    jj = (pixel_ids % cam.width).astype(np.float64)

    acc = np.zeros((r_count, 3))
    for samp in range(opts.spp):
        keys = rng.lane_keys(opts.seed, torch.as_tensor(pixel_ids.astype(np.int64)),
                             samp)
        i_s, j_s = ii, jj
        if not opts.compat.no_pixel_jitter:  # modern AA (camera.py jitter)
            jit = rng.primary_uniforms(keys).numpy().astype(np.float64)
            j_s = jj + jit[:, 0]
            i_s = ii + jit[:, 1]
        pos = (start[None] + x_dir[None] * (pdx * j_s)[:, None]
               - up[None] * (pdy * i_s)[:, None])
        d0 = _norm(pos - eye[None])
        o0 = np.broadcast_to(eye, d0.shape).copy()
        acc += _trace(s, opts, keys, o0, d0, n_slots, num_lights)
    return acc / opts.spp


def _trace(s, opts, keys, o, d, n_slots, num_lights):
    compat = opts.compat
    tri_compat = compat.plane_sign_triangle_test
    r_count = len(o)
    hit, t, tri = _intersect_brute(s, o, d, tri_compat)
    mat = s["mat_id"][np.maximum(tri, 0)]
    emit0 = hit & s["is_emitter"][mat]
    radiance = np.where(emit0[:, None], s["emission"][mat], 0.0)
    alive = hit & ~emit0
    beta = np.ones((r_count, 3))

    for depth in range(opts.max_depth):
        if not alive.any():
            break
        u = rng.bounce_uniforms(keys, depth, n_slots).numpy().astype(np.float64)
        tri_c = np.maximum(tri, 0)
        p = o + d * t[:, None]
        p0, p1, p2 = s["v0"][tri_c], s["v1"][tri_c], s["v2"][tri_c]
        bary = _bary(p, p0, p1, p2)
        pn = (s["n0"][tri_c] * bary[:, :1] + s["n1"][tri_c] * bary[:, 1:2]
              + s["n2"][tri_c] * bary[:, 2:])
        if not compat.unnormalized_shading_normal:
            pn = _norm(pn)
        mat = s["mat_id"][tri_c]
        kd = s["kd"][mat]
        if s["atlas"].shape[0] > 0:  # untextured scenes carry a (0,3) atlas
            # textured kd (quirk #8)
            row = (s["uv0"][tri_c, 0] * bary[:, 0] + s["uv1"][tri_c, 0] * bary[:, 1]
                   + s["uv2"][tri_c, 0] * bary[:, 2])
            col = (s["uv0"][tri_c, 1] * bary[:, 0] + s["uv1"][tri_c, 1] * bary[:, 1]
                   + s["uv2"][tri_c, 1] * bary[:, 2])
            h, w = s["tex_h"][mat], s["tex_w"][mat]
            rr_ = np.clip((row - np.floor(row)) * h, 0, h - 1).astype(int)
            cc_ = np.clip((col - np.floor(col)) * w, 0, w - 1).astype(int)
            texel = s["atlas"][s["tex_offset"][mat] + rr_ * w + cc_]
            kd = np.where(s["has_texture"][mat][:, None], texel, kd)

        # --- NEE (shade :165-232) ---
        l_dir = np.zeros((r_count, 3))
        pn_len = np.linalg.norm(pn, axis=-1)
        # Quirk #4 (compat): the pick range is frozen at the FIRST light's
        # total area; a draw past a light's own CDF silently reuses the
        # previous light's sample point/normal/material (zero Face initially).
        prev_xl = np.zeros((r_count, 3))
        prev_vnl = np.zeros((r_count, 3))
        prev_mat = np.full(r_count, -1, np.int32)
        for li in range(num_lights):
            base = rng.N_BASE_SLOTS + 4 * li
            pick_total = s["light_total"][0] if compat.frozen_light_pick \
                else s["light_total"][li]
            rnd = u[:, base] * pick_total
            found = rnd < s["light_total"][li]
            j = np.clip(np.searchsorted(s["light_face_cum"][li], rnd, side="right"),
                        0, s["light_face_cum"].shape[1] - 1)
            ltri = s["light_face_tri"][li][j]
            r1, r2, r3 = u[:, base + 1], u[:, base + 2], u[:, base + 3]
            if compat.simplex_light_sampling:
                sm = r1 + r2 + r3
                w0, w1, w2 = r1 / sm, r2 / sm, r3 / sm
            else:  # uniform sqrt warp (ops.sampling.sample_triangle_point)
                su = np.sqrt(r1)
                w0, w1, w2 = 1.0 - su, su * (1.0 - r2), su * r2
            xl = (s["v0"][ltri] * w0[:, None] + s["v1"][ltri] * w1[:, None]
                  + s["v2"][ltri] * w2[:, None])
            vnl = (s["n0"][ltri] * w0[:, None] + s["n1"][ltri] * w1[:, None]
                   + s["n2"][ltri] * w2[:, None])
            xl = np.where(found[:, None], xl, prev_xl)
            vnl = np.where(found[:, None], vnl, prev_vnl)
            smat = np.where(found, s["light_mat"][li], prev_mat)
            prev_xl, prev_vnl, prev_mat = xl, vnl, smat
            delta = xl - p
            dist_real = np.linalg.norm(delta, axis=-1)
            dirn = delta / np.maximum(dist_real, 1e-300)[:, None]
            so = p + dirn * opts.ray_epsilon
            hs, ts, tris = _intersect_brute(s, so, dirn, tri_compat)
            if compat.material_equality_visibility:
                vis = hs & (s["mat_id"][np.maximum(tris, 0)] == smat)
            else:  # distance-based (wavefront._nee_direct modern branch)
                vis = (~hs) | (ts + opts.ray_epsilon >= dist_real - 1e-3)
            cos_l = np.abs(np.einsum("rd,rd->r", dirn, _norm(vnl)))
            kd_dots = np.einsum("rd,rd->r", dirn, pn)
            dist = np.maximum(1.0, dist_real) if compat.clamp_light_distance \
                else dist_real
            if compat.double_receiver_cosine:
                cos_r = np.abs(kd_dots) / np.maximum(pn_len, 1e-300)
                geom = cos_l * cos_r / dist ** 2 * s["light_total"][li] * kd_dots
            else:
                cos_r = kd_dots / np.maximum(pn_len, 1e-300)
                geom = cos_l * np.maximum(cos_r, 0.0) / dist ** 2 * s["light_total"][li]
            ok = alive & vis & (kd_dots > 0)
            l_dir += np.where(ok[:, None],
                              kd * s["light_radiance"][li][None] * (geom / PI)[:, None],
                              0.0)
        radiance += np.where(alive[:, None], beta * l_dir, 0.0)

        # --- RR + next ray (nextRay :66-134) ---
        cont = alive & (u[:, 0] < opts.rr_probability)
        beta1 = beta / opts.rr_probability
        ni = s["ni"][mat]
        cos_in = np.einsum("rd,rd->r", d, pn)
        exiting = cos_in > 0
        normal_r = np.where(exiting[:, None], -pn, pn)
        n1 = np.where(exiting, ni, 1.0)
        n2 = np.where(exiting, 1.0, ni)
        rf0 = ((n1 - n2) / (n1 + n2)) ** 2
        fresnel = rf0 + (1 - rf0) * (1 - np.abs(cos_in)) ** 5
        take_refract = (ni > 1) & (fresnel < u[:, 1])
        eta = n1 / n2
        cosi = np.einsum("rd,rd->r", d, normal_r)
        cost2 = 1 - eta ** 2 * (1 - cosi ** 2)
        ok_refr = cost2 >= 0
        d_refr = d * eta[:, None] - normal_r * (eta * cosi + np.sqrt(np.maximum(cost2, 0)))[:, None]
        d_tir = d - normal_r * 2 * cosi[:, None]
        d_trans = np.where(ok_refr[:, None], d_refr, d_tir)
        type_trans = np.where(ok_refr, 2, 1)

        kd_n = np.linalg.norm(kd, axis=-1)
        ks_n = np.linalg.norm(s["ks"][mat], axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(ks_n > 0, kd_n / np.maximum(ks_n, 1e-300), np.inf)
        spec = (ks_n != 0) & (ratio < u[:, 2])
        mirror = d - pn * 2 * np.einsum("rd,rd->r", d, pn)[:, None]
        axis = np.where(spec[:, None], mirror, pn)
        phi = u[:, 3] * 2 * PI
        sin_d = np.sqrt(u[:, 4])
        cos_d = np.sqrt(np.maximum(1 - u[:, 4], 0))
        cos_s = u[:, 4] ** (1.0 / (s["ns"][mat] + 1))
        sin_s = np.sqrt(np.maximum(1 - cos_s ** 2, 0))
        sin_t = np.where(spec, sin_s, sin_d)
        cos_t = np.where(spec, cos_s, cos_d)
        right, upv, front = _lobe_frame(axis)
        d_lobe = _norm(right * (sin_t * np.cos(phi))[:, None] + upv * cos_t[:, None]
                       + front * (sin_t * np.sin(phi))[:, None])
        type_lobe = np.where(spec, 1, 0)

        new_d = np.where(take_refract[:, None], d_trans, d_lobe)
        ray_type = np.where(take_refract, type_trans, type_lobe)
        eps = np.where(take_refract & compat.no_transmission_epsilon,
                       0.0, opts.ray_epsilon)
        new_o = p + new_d * eps[:, None]
        weight = np.where((ray_type == 2)[:, None], 1.0,
                          np.where((ray_type == 1)[:, None], s["ks"][mat], kd))
        beta2 = beta1 * weight

        hit2, t2, tri2 = _intersect_brute(s, new_o, new_d, tri_compat)
        mat2 = s["mat_id"][np.maximum(tri2, 0)]
        emit2 = hit2 & s["is_emitter"][mat2]
        alive2 = cont & hit2
        sees = alive2 & emit2 & (ray_type != 0)
        radiance += np.where(sees[:, None], beta2 * s["emission"][mat2], 0.0)
        alive = alive2 & ~emit2
        o, d, t, tri, beta = new_o, new_d, t2, tri2, beta2
    return radiance

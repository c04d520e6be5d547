"""Plain PyTorch path tracer: the reference's estimate of chosen pixels.

An independent re-derivation of the upstream integrator's semantics
(MTPC/pathTracing.cpp: shade :137-266, nextRay :66-134, generateImg
:274-331), with every quirk flag of the configuration's ``compat`` group,
keyed to the frozen RNG in ``rng.py`` so that each path draws the
uniforms the program's path draws.  It follows the NumPy float64 oracle of
``montecarlopathtracing_torch/oracle/cpu_reference.py`` at commit 8674dbe,
in PyTorch so that it runs on the card after the measured window and can be
differentiated:

* intersection is brute force over every triangle of the scene, in blocks
  of rays (no acceleration structure, no cluster order);
* lanes are (pixel, sample) pairs; each depth works on the lanes still
  alive, so a ray is tested only where the path needs it;
* the gradient is the detached-sampling pathwise one: hits, visibility,
  Russian roulette, the lobe choice and the sampled directions are
  computed from detached values, and the radiance stays a product of the
  material albedos (``kd``, ``ks``), the texels (``atlas``) and the light
  radiance, through which autograd differentiates.

``counts`` (a dict) receives the ray queries the estimate needed: one
primary a pixel when every sample shares it (compat), one shadow query per
light and live lane at each depth, and one query per continuing path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import rng

PI = math.pi
# Ray-triangle tests held at once in one block: (rays x triangles) elements.
BLOCK_ELEMENTS = 1 << 25


def _norm(v):
    tiny = torch.finfo(v.dtype).tiny
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=tiny)


def _dot(a, b):
    return (a * b).sum(-1)


class _Triangles:
    """Per-triangle constants of the two triangle tests (detached)."""

    def __init__(self, scene, compat_test: bool):
        p0, p1, p2 = scene.v0, scene.v1, scene.v2
        self.compat = compat_test
        if compat_test:
            gn = scene.geom_n
            self.gn = gn
            self.pg = _dot(p0, gn)
            self.m, self.k = [], []
            for a, b in ((p1 - p0, p0), (p2 - p1, p1), (p0 - p2, p2)):
                m = torch.linalg.cross(gn, a)
                self.m.append(m)
                self.k.append(_dot(b, m))
        else:
            self.p0 = p0
            self.e1, self.e2 = p1 - p0, p2 - p0
            self.n_raw = torch.linalg.cross(self.e1, self.e2)
            self.ku = torch.linalg.cross(p0, self.e2)
            self.kv = torch.linalg.cross(self.e1, p0)
            self.pn = _dot(p0, self.n_raw)
        self.n = int(p0.shape[0])

    def _block(self, o, d):
        if self.compat:
            t = (self.pg[None] - o @ self.gn.T) / (d @ self.gn.T)
            c = [o @ m.T + t * (d @ m.T) - k[None] for m, k in zip(self.m, self.k)]
            hit = (c[0] * c[1] >= 0) & (c[0] * c[2] >= 0) & (c[1] * c[2] >= 0)
        else:
            w = torch.linalg.cross(o, d)
            inv_det = 1.0 / -(d @ self.n_raw.T)
            t = (o @ self.n_raw.T - self.pn[None]) * inv_det
            u = (w @ self.e2.T + d @ self.ku.T) * inv_det
            v = (-(w @ self.e1.T) + d @ self.kv.T) * inv_det
            hit = (u >= 0) & (v >= 0) & (u + v <= 1)
        hit &= torch.isfinite(t) & (t > 0)
        t = torch.where(hit, t, torch.full_like(t, math.inf))
        tri = torch.argmin(t, dim=1)
        tbest = t.gather(1, tri[:, None])[:, 0]
        return tbest, tri

    def nearest(self, o, d):
        """(hit (R,), t (R,), tri (R,) or -1) of the nearest triangle."""
        o, d = o.detach(), d.detach()
        step = max(1, BLOCK_ELEMENTS // max(self.n, 1))
        ts, tris = [], []
        for a in range(0, o.shape[0], step):
            t, tri = self._block(o[a:a + step], d[a:a + step])
            ts.append(t)
            tris.append(tri)
        if not ts:
            empty = o.new_zeros((0,))
            return empty.bool(), empty, empty.long()
        t, tri = torch.cat(ts), torch.cat(tris)
        hit = torch.isfinite(t)
        return hit, torch.where(hit, t, torch.full_like(t, 1e30)), \
            torch.where(hit, tri, torch.full_like(tri, -1))


def _bary(p, p0, p1, p2):
    e1, e2, e3 = p2 - p1, p0 - p2, p1 - p0
    n = torch.linalg.cross(e1, e2)
    an = _dot(n, n)
    b0 = _dot(torch.linalg.cross(e1, p - p2), n) / an
    b1 = _dot(torch.linalg.cross(e2, p - p0), n) / an
    b2 = _dot(torch.linalg.cross(e3, p - p1), n) / an
    return torch.stack([b0, b1, b2], -1)


def _lobe_frame(axis):
    ax, ay, az = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(ax)
    use_x = (ax.abs() > ay.abs())[:, None]
    front = _norm(torch.where(use_x, torch.stack([az, zero, -ax], -1),
                              torch.stack([zero, -az, ay], -1)))
    return torch.linalg.cross(axis, front), axis, front


def primary_rays(scene, pix, jitter=None):
    """Camera rays through the pixels' top-left lattice corners, or through
    the corners plus ``jitter`` (R, 2) when the primaries are jittered."""
    dt = scene.eye.dtype
    eye = scene.eye
    up = _norm(scene.up[None])[0]
    view = scene.look_at - eye
    length = torch.linalg.vector_norm(view)
    dy = math.tan(scene.fovy / 2 / 180 * PI) * length
    dx = dy / scene.height * scene.width
    pdx, pdy = 2 * dx / scene.width, 2 * dy / scene.height
    x_dir = _norm(torch.linalg.cross(view, up)[None])[0]
    start = scene.look_at - x_dir * dx + up * dy
    ii = (pix // scene.width).to(dt)
    jj = (pix % scene.width).to(dt)
    if jitter is not None:
        jj = jj + jitter[:, 0]
        ii = ii + jitter[:, 1]
    pos = (start[None] + x_dir[None] * (pdx * jj)[:, None]
           - up[None] * (pdy * ii)[:, None])
    d = _norm(pos - eye[None])
    return eye[None].expand_as(d).clone(), d


def render(scene, opts: dict, seed: int, pixel_ids, spp: int,
           sample_offset: int = 0, params: Optional[dict] = None,
           counts: Optional[dict] = None):
    """Mean radiance (P, 3) of the pixels ``pixel_ids`` over samples
    ``[sample_offset, sample_offset + spp)`` of the RNG streams of ``seed``.

    ``opts``: ``rr_probability``, ``max_depth``, ``ray_epsilon`` and the
    ``compat`` flags, as the configuration states them.  ``params``
    optionally replaces ``kd``, ``ks``, ``light_radiance`` and ``atlas``
    with tensors to differentiate."""
    compat = opts["compat"]
    rr_p, eps = float(opts["rr_probability"]), float(opts["ray_epsilon"])
    dev, dt = scene.v0.device, scene.v0.dtype
    tiny = torch.finfo(dt).tiny
    counts = counts if counts is not None else {}
    for k in ("primary", "shadow", "bounce"):
        counts.setdefault(k, 0)
    p = dict(kd=scene.kd, ks=scene.ks, light_radiance=scene.light_radiance,
             atlas=scene.atlas)
    p.update(params or {})
    kd_t, ks_t, lrad, atlas = p["kd"], p["ks"], p["light_radiance"], p["atlas"]
    tris = _Triangles(scene, compat["plane_sign_triangle_test"])
    num_lights = scene.num_lights
    n_slots = rng.n_bounce_slots(num_lights)
    n_mat = scene.kd.shape[0]
    emission = torch.zeros((n_mat, 3), dtype=dt, device=dev).index_put(
        (scene.light_mat,), lrad.to(dt))
    is_emitter = torch.zeros(n_mat, dtype=torch.bool, device=dev)
    is_emitter[scene.light_mat] = True
    textured = atlas.shape[0] > 0

    pixel_ids = torch.as_tensor(pixel_ids, device=dev).long()
    n_pix = pixel_ids.shape[0]
    lane_pix = pixel_ids.repeat_interleave(spp)
    lane_samp = torch.arange(spp, device=dev).repeat(n_pix) + sample_offset
    keys = rng.lane_keys(seed, lane_pix, lane_samp)
    r = lane_pix.shape[0]

    if compat["no_pixel_jitter"]:
        o, d = primary_rays(scene, pixel_ids)
        hit, t, tri = tris.nearest(o, d)
        counts["primary"] += n_pix
        o, d, hit, t, tri = (x.repeat_interleave(spp, 0) for x in (o, d, hit, t, tri))
    else:
        jit = rng.primary_uniforms(keys).to(dt)
        o, d = primary_rays(scene, lane_pix, jit)
        hit, t, tri = tris.nearest(o, d)
        counts["primary"] += r
    mat = scene.mat_id[tri.clamp(min=0)]
    emit0 = hit & is_emitter[mat]
    radiance = torch.where(emit0[:, None], emission[mat],
                           torch.zeros((), dtype=dt, device=dev))
    lanes = torch.nonzero(hit & ~emit0)[:, 0]
    o, d, t, tri = o[lanes], d[lanes], t[lanes], tri[lanes]
    beta = torch.ones((lanes.shape[0], 3), dtype=dt, device=dev)

    for depth in range(int(opts["max_depth"])):
        if lanes.shape[0] == 0:
            break
        n = lanes.shape[0]
        u = rng.bounce_uniforms(keys[lanes], depth, n_slots).to(dt)
        pos = o + d * t[:, None]
        p0, p1, p2 = scene.v0[tri], scene.v1[tri], scene.v2[tri]
        bary = _bary(pos, p0, p1, p2)
        pn = (scene.n0[tri] * bary[:, :1] + scene.n1[tri] * bary[:, 1:2]
              + scene.n2[tri] * bary[:, 2:])
        if not compat["unnormalized_shading_normal"]:
            pn = _norm(pn)
        mat = scene.mat_id[tri]
        kd_hit = kd_t[mat]
        if textured:
            row = (scene.uv0[tri, 0] * bary[:, 0] + scene.uv1[tri, 0] * bary[:, 1]
                   + scene.uv2[tri, 0] * bary[:, 2])
            col = (scene.uv0[tri, 1] * bary[:, 0] + scene.uv1[tri, 1] * bary[:, 1]
                   + scene.uv2[tri, 1] * bary[:, 2])
            h, w = scene.tex_h[mat], scene.tex_w[mat]
            rr_ = torch.minimum(torch.clamp(torch.nan_to_num(
                (row - torch.floor(row)) * h), min=0), (h - 1).to(dt)).long()
            cc_ = torch.minimum(torch.clamp(torch.nan_to_num(
                (col - torch.floor(col)) * w), min=0), (w - 1).to(dt)).long()
            texel = atlas[scene.tex_offset[mat] + rr_ * w + cc_]
            kd_hit = torch.where(scene.has_texture[mat][:, None], texel, kd_hit)
        kd_det = kd_hit.detach()

        # Next-event estimation, one shadow query per light.
        l_dir = torch.zeros((n, 3), dtype=dt, device=dev)
        pn_len = torch.linalg.vector_norm(pn, dim=-1)
        prev_xl = torch.zeros((n, 3), dtype=dt, device=dev)
        prev_vnl = torch.zeros((n, 3), dtype=dt, device=dev)
        prev_mat = torch.full((n,), -1, dtype=torch.long, device=dev)
        for li in range(num_lights):
            base = rng.N_BASE_SLOTS + 4 * li
            pick_total = (scene.light_total[0] if compat["frozen_light_pick"]
                          else scene.light_total[li])
            rnd = u[:, base] * pick_total
            found = rnd < scene.light_total[li]
            j = torch.searchsorted(scene.light_cum[li].contiguous(),
                                   rnd.contiguous(), right=True)
            j = j.clamp(0, scene.light_cum.shape[1] - 1)
            ltri = scene.light_faces[li][j]
            r1, r2, r3 = u[:, base + 1], u[:, base + 2], u[:, base + 3]
            if compat["simplex_light_sampling"]:
                sm = r1 + r2 + r3
                w0, w1, w2 = r1 / sm, r2 / sm, r3 / sm
            else:
                su = torch.sqrt(r1)
                w0, w1, w2 = 1.0 - su, su * (1.0 - r2), su * r2
            xl = (scene.v0[ltri] * w0[:, None] + scene.v1[ltri] * w1[:, None]
                  + scene.v2[ltri] * w2[:, None])
            vnl = (scene.n0[ltri] * w0[:, None] + scene.n1[ltri] * w1[:, None]
                   + scene.n2[ltri] * w2[:, None])
            xl = torch.where(found[:, None], xl, prev_xl)
            vnl = torch.where(found[:, None], vnl, prev_vnl)
            smat = torch.where(found, scene.light_mat[li], prev_mat)
            prev_xl, prev_vnl, prev_mat = xl, vnl, smat
            delta = xl - pos
            dist_real = torch.linalg.vector_norm(delta, dim=-1)
            dirn = delta / torch.clamp(dist_real, min=tiny)[:, None]
            hs, ts, tri_s = tris.nearest(pos + dirn * eps, dirn)
            counts["shadow"] += n
            if compat["material_equality_visibility"]:
                vis = hs & (scene.mat_id[tri_s.clamp(min=0)] == smat)
            else:
                vis = (~hs) | (ts + eps >= dist_real - 1e-3)
            cos_l = _dot(dirn, _norm(vnl)).abs()
            kd_dots = _dot(dirn, pn)
            dist = torch.clamp(dist_real, min=1.0) if compat["clamp_light_distance"] \
                else dist_real
            if compat["double_receiver_cosine"]:
                cos_r = kd_dots.abs() / torch.clamp(pn_len, min=tiny)
                geom = cos_l * cos_r / dist ** 2 * scene.light_total[li] * kd_dots
            else:
                cos_r = kd_dots / torch.clamp(pn_len, min=tiny)
                geom = (cos_l * torch.clamp(cos_r, min=0.0) / dist ** 2
                        * scene.light_total[li])
            ok = vis & (kd_dots > 0)
            l_dir = l_dir + torch.where(
                ok[:, None], kd_hit * lrad[li][None] * (geom / PI)[:, None],
                torch.zeros((), dtype=dt, device=dev))
        radiance = radiance.index_add(0, lanes, beta * l_dir)

        # Russian roulette and the next segment.
        cont = u[:, 0] < rr_p
        ni = scene.ni[mat]
        cos_in = _dot(d, pn)
        exiting = cos_in > 0
        normal_r = torch.where(exiting[:, None], -pn, pn)
        n1 = torch.where(exiting, ni, torch.ones_like(ni))
        n2 = torch.where(exiting, torch.ones_like(ni), ni)
        rf0 = ((n1 - n2) / (n1 + n2)) ** 2
        fresnel = rf0 + (1 - rf0) * (1 - cos_in.abs()) ** 5
        take_refract = (ni > 1) & (fresnel < u[:, 1])
        eta = n1 / n2
        cosi = _dot(d, normal_r)
        cost2 = 1 - eta ** 2 * (1 - cosi ** 2)
        ok_refr = cost2 >= 0
        d_refr = (d * eta[:, None] - normal_r
                  * (eta * cosi + torch.sqrt(torch.clamp(cost2, min=0)))[:, None])
        d_tir = d - normal_r * 2 * cosi[:, None]
        d_trans = torch.where(ok_refr[:, None], d_refr, d_tir)
        type_trans = torch.where(ok_refr, 2, 1)

        kd_n = torch.linalg.vector_norm(kd_det, dim=-1)
        ks_n = torch.linalg.vector_norm(scene.ks[mat], dim=-1)
        ratio = torch.where(ks_n > 0, kd_n / torch.clamp(ks_n, min=tiny),
                            torch.full_like(ks_n, math.inf))
        spec = (ks_n != 0) & (ratio < u[:, 2])
        mirror = d - pn * 2 * _dot(d, pn)[:, None]
        axis = torch.where(spec[:, None], mirror, pn)
        phi = u[:, 3] * 2 * PI
        sin_d = torch.sqrt(u[:, 4])
        cos_d = torch.sqrt(torch.clamp(1 - u[:, 4], min=0))
        cos_s = u[:, 4] ** (1.0 / (scene.ns[mat] + 1))
        sin_s = torch.sqrt(torch.clamp(1 - cos_s ** 2, min=0))
        sin_t = torch.where(spec, sin_s, sin_d)
        cos_t = torch.where(spec, cos_s, cos_d)
        right, upv, front = _lobe_frame(axis)
        d_lobe = _norm(right * (sin_t * torch.cos(phi))[:, None]
                       + upv * cos_t[:, None]
                       + front * (sin_t * torch.sin(phi))[:, None])
        type_lobe = torch.where(spec, 1, 0)
        new_d = torch.where(take_refract[:, None], d_trans, d_lobe)
        ray_type = torch.where(take_refract, type_trans, type_lobe)
        if compat["no_transmission_epsilon"]:
            step = torch.where(take_refract, 0.0, eps).to(dt)
        else:
            step = torch.full_like(t, eps)
        new_o = pos + new_d * step[:, None]
        weight = torch.where((ray_type == 2)[:, None],
                             torch.ones((), dtype=dt, device=dev),
                             torch.where((ray_type == 1)[:, None], ks_t[mat], kd_hit))
        beta2 = beta / rr_p * weight

        sel = torch.nonzero(cont)[:, 0]
        hit2, t2, tri2 = tris.nearest(new_o[sel], new_d[sel])
        counts["bounce"] += int(sel.shape[0])
        mat2 = scene.mat_id[tri2.clamp(min=0)]
        emit2 = hit2 & is_emitter[mat2]
        beta2 = beta2[sel]
        sees = torch.nonzero(emit2 & (ray_type[sel] != 0))[:, 0]
        radiance = radiance.index_add(0, lanes[sel][sees],
                                      beta2[sees] * emission[mat2[sees]])
        keep = torch.nonzero(hit2 & ~emit2)[:, 0]
        lanes = lanes[sel][keep]
        o, d = new_o[sel][keep], new_d[sel][keep]
        t, tri, beta = t2[keep], tri2[keep], beta2[keep]
    return radiance.reshape(n_pix, spp, 3).sum(1) / spp

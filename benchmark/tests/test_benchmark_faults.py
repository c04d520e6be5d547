"""With the timed path broken underneath, a run's ``correct`` comes out
false: once for each fault a cell can have (an answer altered where it is
produced, half of the samples left out with the mean over the rest, a step
that returns its state unchanged)."""

import torch

from benchmark.tests import _tiny


def box():
    return _tiny.cell("cornell-1024-spp25", check_pixels=256)


def test_sound_box_is_correct():
    assert _tiny.run(box())["correct"]


def test_an_altered_frame_fails(monkeypatch):
    from montecarlopathtracing_torch.integrator import wavefront as W

    real = W.render_image_host_chunked

    def altered(*a, **kw):
        img, rays = real(*a, **kw)
        return img * 1.1, rays

    monkeypatch.setattr(W, "render_image_host_chunked", altered)
    assert not _tiny.run(box())["correct"]


def test_half_the_samples_fails(monkeypatch):
    from montecarlopathtracing_torch.integrator import wavefront as W

    real = W.render_image_host_chunked

    def half(scene, bvh, opts, **kw):
        return real(scene, bvh, opts.replace(spp=max(1, opts.spp // 2)), **kw)

    monkeypatch.setattr(W, "render_image_host_chunked", half)
    assert not _tiny.run(_tiny.cell("cornell-1024-spp25", spp=4,
                                    check_pixels=256))["correct"]


def grad_cell():
    return _tiny.cell("interior-720p-grad-spp4", check_pixels=512)


def test_a_step_that_returns_no_change_fails(monkeypatch):
    from montecarlopathtracing_torch.diff import gradients as G

    def unchanged(value, leaves):
        return leaves.map(torch.zeros_like)

    monkeypatch.setattr(G, "param_grads", unchanged)
    assert not _tiny.run(grad_cell())["correct"]


def test_a_gradient_of_half_the_pixels_fails(monkeypatch):
    from montecarlopathtracing_torch.diff import gradients as G

    real = G.param_grads

    def half(value, leaves):
        return real(value, leaves).map(lambda g: g * 0.5)

    monkeypatch.setattr(G, "param_grads", half)
    assert not _tiny.run(grad_cell())["correct"]


def test_sound_gradient_steps_are_correct():
    assert _tiny.run(grad_cell())["correct"]


def test_the_window_times_the_users_call(monkeypatch):
    from montecarlopathtracing_torch.diff import gradients as G

    real, calls = G.loss_and_grad, []

    def counted(params, scene, bvh, opts, target, device=None):
        calls.append(tuple(target.shape))
        return real(params, scene, bvh, opts, target, device=device)

    monkeypatch.setattr(G, "loss_and_grad", counted)
    cell = grad_cell()
    out = _tiny.run(cell)
    # Two warm-up steps, the window's, then the check's: each against a
    # whole-frame target.
    h, w = _tiny.SIZES["procedural_interior"]["height"], \
        _tiny.SIZES["procedural_interior"]["width"]
    assert len(calls) == 2 + out["attempted"] + cell.traffic["check_steps"]
    assert set(calls) == {(h, w, 3)}


def test_an_altered_gradient_image_fails(monkeypatch):
    from montecarlopathtracing_torch.diff import gradients as G

    real = G.render_with_params

    def altered(*a, **kw):
        return real(*a, **kw) * 1.1

    monkeypatch.setattr(G, "render_with_params", altered)
    assert not _tiny.run(grad_cell())["correct"]

"""The plain reference against the port's plain path (its CPU route) at
16^3-32^3: images, the loss and every leaf's gradient."""

import pytest
import torch

from vr_bench import inputs, program
from vr_bench.reference import lit_march as ref
from vr_bench.tests.scenes import small_inputs, small_scene


def _port_scene(n, lookup, rotations):
    cfg, inp = small_inputs(n, lookup)
    return program.scene(cfg, inp, rotations, "cpu"), inputs.image_size(cfg, inp.emission)


@pytest.mark.parametrize("n,lookup,rot", [(16, False, (125, 25, 0)), (32, False, (30, 80, 10)),
                                          (16, True, (125, 25, 0)), (24, True, (200, -40, 5))])
def test_image_equals_the_ports_plain_march(n, lookup, rot):
    scene, (w, h) = _port_scene(n, lookup, [rot])
    got = program.render(scene, w, h).to(torch.float64)
    want = ref.render_image(small_scene(n, lookup, torch.float64, [rot]))
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("lookup", [False, True])
def test_loss_and_gradients_equal_the_ports_plain_replay(lookup):
    n = 16
    scene, (w, h) = _port_scene(n, lookup, [(125, 25, 0)])
    target = program.render(scene, w, h) * 0.7
    params, static = program.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
    opt = torch.optim.SGD(list(params.values()), lr=0.0)
    loss = program.train_step(params, opt, static, static.options(w, h), target)

    rs = small_scene(n, lookup, torch.float64)
    leaves = {"emission": rs.emission * 1.3 + 0.05, "absorption": rs.absorption,
              "factor_emission": rs.factor_emission, "factor_absorption": rs.factor_absorption,
              "factor_reflection": rs.factor_reflection, "color": rs.color}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    rs = rs.replace(**leaves)
    ref_loss, _ = ref.loss_and_grads(rs, target.to(torch.float64))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for k, v in leaves.items():
        g_ref, g = v.grad, params[k].grad.to(torch.float64)
        scale = float(g_ref.abs().max())
        assert float((g - g_ref).abs().max()) <= 1e-3 * scale, k

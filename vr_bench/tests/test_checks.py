"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a small size (the card's look skipped): sound runs pass; the
control (the reference in bfloat16 in the program's place) and every
fault a cell can have fail."""

import pytest
import torch

from vr_bench import cell, checks, inputs, program, run
from vr_bench.loops import fit, orbit

N = 16   # (D, H, W) = (8, 12, 16), a 16 x 12 image
SEED = 2 ** 31 + 11


def _run(workload, monkeypatch=None):
    return run.run_cell(run.load_benchmark(), workload, SEED, seconds=0.0, trace=False,
                        device="cpu", size=N)


def _ctx(workload, seed=SEED):
    spec = run.cell_spec(run.load_benchmark(), workload)
    inp = inputs.make_inputs(spec["config"], torch.device("cpu"), n=N)
    w, h = inputs.image_size(spec["config"], inp.emission)
    return cell.Context(workload=workload, cfg=spec["config"], traffic=spec["traffic"],
                        seed=seed, device=torch.device("cpu"), inputs=inp, width=w, height=h)


@pytest.mark.parametrize("workload", ["vibez-otf.orbit", "vibez-lookup.orbit",
                                      "vibez-otf.fit", "vibez-lookup.fit"])
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["vibez-otf.orbit", "vibez-lookup.orbit"])
def test_the_control_fails_a_frame(workload):
    ctx = _ctx(workload)
    numbers = orbit.check(ctx, cell.Window(seconds=1.0, frames=3), dtype=torch.bfloat16)
    assert not all(v["ok"] for v in checks.verdict(numbers, checks.limits(workload)))


@pytest.mark.parametrize("workload", ["vibez-otf.fit", "vibez-lookup.fit"])
def test_the_control_fails_a_fit(workload):
    ctx = _ctx(workload)
    numbers = checks.fit_numbers(fit.reference(ctx, dtype=torch.bfloat16), fit.reference(ctx),
                                 checks.grid_leaves(workload))
    assert not all(v["ok"] for v in checks.verdict(numbers, checks.limits(workload)))


@pytest.mark.parametrize("workload", ["vibez-otf.orbit", "vibez-lookup.orbit"])
def test_an_answer_altered_where_it_is_made_fails(workload, monkeypatch):
    make = program.renderer

    def altered(*a, **kw):
        r = make(*a, **kw)
        render = r.render

        def render_altered():
            img = render()
            return img * torch.tensor([1.25, 1.0, 1.0], dtype=img.dtype)

        r.render = render_altered
        return r

    monkeypatch.setattr(program, "renderer", altered)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", ["vibez-otf.fit", "vibez-lookup.fit"])
def test_a_step_that_leaves_its_state_unchanged_fails(workload, monkeypatch):
    step = program.train_step

    def unchanged(params, optimizer, scene, opts, target):
        before = {k: p.detach().clone() for k, p in params.items()}
        loss = step(params, optimizer, scene, opts, target)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(before[k])
        return loss

    monkeypatch.setattr(program, "train_step", unchanged)
    res = _run(workload)
    assert not res["correct"]
    assert res["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["vibez-otf.fit", "vibez-lookup.fit"])
def test_half_of_the_batch_left_out_fails(workload, monkeypatch):
    vr = program.port()

    def half(params, optimizer, scene, opts, target):
        # the loss and its gradient over the top half of the rays alone,
        # doubled: the mean over the rest
        with torch.no_grad():
            merged = vr.train.merge_params(params, scene)
            img = vr.render_forward_fast(merged, opts)
            resid = img - target
            resid[opts.height // 2:] = 0.0
            resid *= 2 ** 0.5
            loss = torch.sum(resid ** 2)
            _, grads = vr.voxel_grads_fast(merged, opts, 2.0 * resid, image=img)
            for k, p in params.items():
                p.grad = grads[k].reshape(p.shape)
        optimizer.step()
        return loss

    monkeypatch.setattr(program, "train_step", half)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", ["vibez-otf.fit", "vibez-lookup.fit"])
def test_voxel_gradients_scaled_as_a_whole_fail(workload, monkeypatch):
    # Adam's change does not see a gradient scaled as a whole, nor does the
    # median leaf, which is a factor's: the grid leaves' own gap does
    vr = program.port()
    grid = checks.grid_leaves(workload)

    def scaled(params, optimizer, scene, opts, target):
        with torch.no_grad():
            merged = vr.train.merge_params(params, scene)
            img = vr.render_forward_fast(merged, opts)
            loss = torch.sum((img - target) ** 2)
            _, grads = vr.voxel_grads_fast(merged, opts, 2.0 * (img - target), image=img)
            for k, p in params.items():
                p.grad = grads[k].reshape(p.shape) * (1.5 if k in grid else 1.0)
        optimizer.step()
        return loss

    monkeypatch.setattr(program, "train_step", scaled)
    res = _run(workload)
    assert not res["correct"]
    assert res["checks"]["grid_grad_gap"]["value"] > res["checks"]["grid_grad_gap"]["limit"]

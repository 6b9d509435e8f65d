"""A whole run at TINY sizes with the timed path broken underneath: the
comparison with the reference, held to the cell's own limit, comes out
not correct for each fault the cells can have. (Both cells run on one
chip, so there is no exchange between chips to leave out.)"""
import pytest
import torch

from h100bench.lib import harness
from h100bench.tests import tiny


def _half_rows(orig):
    """The model on the first half of the batch; the rest of the rows get
    the mean of that half's outputs."""
    def apply(model, x, *args):
        n = x.shape[0] // 2
        out = orig(model, x[:n], *(a[:n] for a in args))
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])
    return apply


def _inverted(orig):
    return lambda x: 255 - orig(x)


def _serve_fault(mp, fault):
    from tinyfusers_tpu_torch.serve import engine

    if fault == "state_unchanged":
        mp.setattr(engine.Engine, "_slot_step",
                   staticmethod(lambda unet, latents, *a: latents))
    elif fault == "half_batch":
        mp.setattr(engine.unet_model, "apply", _half_rows(engine.unet_model.apply))
    else:
        mp.setattr(engine.vae_model, "to_image", _inverted(engine.vae_model.to_image))


def _gen_fault(mp, fault):
    from tinyfusers_tpu_torch.pipeline import sd3

    if fault == "state_unchanged":
        mp.setattr(sd3.rf, "sample", lambda model_fn, noise, num_steps, **kw: noise)
    elif fault == "half_batch":
        mp.setattr(sd3.mmdit, "apply", _half_rows(sd3.mmdit.apply))
    else:
        mp.setattr(sd3.vae, "to_image", _inverted(sd3.vae.to_image))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.GEN])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    bench, roots = tiny.bench_and_roots(tmp_path)
    (_serve_fault if cell == tiny.SERVE else _gen_fault)(monkeypatch, fault)
    res = harness.run_workload(cell, 23, 1.5, False, device="cpu", bench=bench, roots=roots)
    c = res["checks"]["image_rms_levels"]
    assert res["correct"] is False and c["value"] > c["limit"], c

"""Evaluation (port of tinyfusers_tpu/eval/): the CLIP scorer and CLIP
score (``clip_score``), FID and CLIP-FID (``fid``).

Import the submodule (``from tinyfusers_tpu_torch.eval import
clip_score``) and call ``clip_score.clip_score(...)``: the module is not
shadowed by a function of the same name.
"""
from . import clip_score, fid  # noqa: F401
from .clip_score import CLIPScorer, load_scorer_params  # noqa: F401

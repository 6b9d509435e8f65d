"""CLIP score: prompt-image agreement in the CLIP joint space (port of
tinyfusers_tpu/eval/clip_score.py).

score(image, text) = 100 * cosine(E_img(image), E_txt(text)), both
embeddings in the joint space (768-d for ViT-L/14): the
``torchmetrics.multimodal.CLIPScore`` definition without its max(0, .)
clamp, as in the JAX package (signed values serve deltas better).

``CLIPScorer`` holds the text tower (models/clip.py with a
``text_projection``) and the vision tower (models/clip_vision.py), in
fp32: the scorer stays fp32 whatever dtype the pipeline it scores runs
in, and each cosine is taken over the fp32 norm. With real weights
(``load_scorer_params`` of an HF CLIPModel file, openai/clip-vit-large-
patch14) the scores mean something; with seeded weights they prove the
path. On the card, TF32 changes the fp32 patch conv and matmuls
(cuDNN's convolutions take it by default): callers that want exact fp32
scores switch it off, as tools/accuracy_eval_torch.py does.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models import clip as clip_model
from ..models import clip_vision
from ..models.layers import init_weights

# an HF CLIPModel's keys, re-keyed under this prefix, are an SD1.x file's
# text tower (io/state_map.py's CLIP_PREFIX is this + "text_model")
_TEXT_PARENT = "cond_stage_model.transformer."


class CLIPScorer(nn.Module):
    """The two CLIP towers on one device, fp32.

    text_cfg defaults to ViT-L/14's text tower (SD1.x's conditioning
    geometry with a 768-wide ``text_projection``). device defaults to
    "cuda" and raises without a GPU. seed fills the text tower from
    ``seed`` and the vision tower from ``seed + 1`` with the JAX init's
    distributions; seed=None leaves them empty for ``load_scorer_params``."""

    def __init__(self, text_cfg: Optional[clip_model.CLIPConfig] = None,
                 vision_cfg: clip_vision.CLIPVisionConfig = clip_vision.VIT_L_14, *,
                 device: Union[str, torch.device] = "cuda", seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.text_cfg = text_cfg or clip_model.CLIPConfig(projection_dim=768)
        self.vision_cfg = vision_cfg
        self.text = clip_model.CLIPTextModel(self.text_cfg, device=dev, dtype=torch.float32)
        self.vision = clip_vision.CLIPVisionModel(vision_cfg, device=dev, dtype=torch.float32,
                                                  seed=None if seed is None else seed + 1)
        if seed is not None:
            init_weights(self.text, seed)

    @property
    def device(self) -> torch.device:
        return self.vision.class_embedding.device


def load_scorer_params(path, text_cfg: Optional[clip_model.CLIPConfig] = None,
                       vision_cfg: clip_vision.CLIPVisionConfig = clip_vision.VIT_L_14, *,
                       device: Union[str, torch.device] = "cuda") -> CLIPScorer:
    """An HF CLIPModel checkpoint (.safetensors or torch-zip: text_model.*,
    vision_model.*, text_projection, visual_projection) -> a CLIPScorer on
    ``device`` (the GPU unless the caller asks for the CPU). The text keys
    are re-keyed under an SD1.x file's prefix for io/state_map.py's CLIP
    map, as the JAX loader does."""
    from ..io import checkpoints, state_map

    scorer = CLIPScorer(text_cfg, vision_cfg, device=device, seed=None)
    state = checkpoints.load_state_dict(path)
    state_map.clip_from_state({_TEXT_PARENT + k: v for k, v in state.items()}, scorer.text)
    state_map.clip_vision_from_state(state, scorer.vision)
    return scorer


def _normalized(e: torch.Tensor) -> torch.Tensor:
    return e / torch.linalg.vector_norm(e.float(), dim=-1, keepdim=True)


@torch.inference_mode()
def embed_images(scorer: CLIPScorer, images) -> torch.Tensor:
    """images (B, H, W, 3) uint8 or float RGB (a tensor or an array) ->
    L2-normalized (B, P) on the scorer's device."""
    pixels = clip_vision.preprocess(torch.as_tensor(images).to(scorer.device),
                                    scorer.vision_cfg)
    return _normalized(clip_vision.apply(scorer.vision, pixels))


@torch.inference_mode()
def embed_texts(scorer: CLIPScorer, input_ids) -> torch.Tensor:
    """Tokenized prompts (B, T) -> L2-normalized (B, P), pooled at each
    sequence's first EOT id (models/clip.py::apply_pooled)."""
    ids = torch.as_tensor(input_ids).to(scorer.device).long()
    return _normalized(clip_model.apply_pooled(scorer.text, ids))


def clip_score(scorer: CLIPScorer, images, input_ids) -> np.ndarray:
    """Per-pair CLIP scores (B,) as numpy: 100 * cosine similarity of each
    image (B, H, W, 3) with its prompt's ids (B, T) (tokenizer/bpe.py with
    the real merges file for real use)."""
    ei = embed_images(scorer, images)
    et = embed_texts(scorer, input_ids)
    return (100.0 * (ei * et).sum(dim=-1)).cpu().numpy()

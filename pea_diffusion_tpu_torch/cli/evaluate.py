"""CLIP-score and CLIP-FID of generated images with a Chinese-CLIP (or
OpenAI-CLIP) dual tower (port of ``pea_diffusion_tpu/cli/evaluate.py``).

The text feature is the BERT tower's [CLS] state times
`text_projection.weight`; the image feature the vision tower's projected
(or pooled) class token. CLIP-score is the mean cosine of each image with
its prompt, clamped at 0; CLIP-FID the Fréchet distance of the image
features of two image sets (``utils/fid.py``), not comparable to
InceptionV3-FID numbers such as the paper's. Both towers run in fp32, as the
JAX CLI's do. `--demo` builds tiny random towers from seeds (BERT_TINY and a
two-layer ViT) with the one-id-per-character tokenizer of the generate CLI:
the plumbing runs end to end on real image files and the numbers mean
nothing.

Usage:
  python -m pea_diffusion_tpu_torch.cli.evaluate \
      --clip-dir chinese-clip-vit-huge-patch14 \
      --images out/*.png --prompts prompts.txt [--fid-ref real/*.png]
  python -m pea_diffusion_tpu_torch.cli.evaluate --demo --device cpu \
      --images out/*.png --prompts prompts.txt --fid-ref ref/*.png
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch
from torch import nn

DEMO_TEXT_LENGTH = 16


def clip_score(text_feats: torch.Tensor, image_feats: torch.Tensor) -> torch.Tensor:
    """Per-row cosine similarity of text and image features, clamped at 0
    (CLIP-score with w = 1)."""
    t = text_feats / torch.linalg.norm(text_feats, dim=-1, keepdim=True)
    v = image_feats / torch.linalg.norm(image_feats, dim=-1, keepdim=True)
    return torch.clamp((t * v).sum(dim=-1), min=0.0)


@dataclasses.dataclass
class DualTower:
    """The text tower (BERT) with its optional projection, and the vision
    tower, on one device."""

    text: nn.Module
    text_projection: Optional[torch.Tensor]  # [P, H] (a Linear's weight)
    vision: nn.Module
    device: torch.device

    def text_features(self, ids) -> torch.Tensor:
        """Token ids [N, T] -> text features [N, P] (or [N, H] without a
        projection), fp32 on the tower's device."""
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
            pooled = self.text(ids).pooled.float()
            if self.text_projection is None:
                return pooled
            return pooled @ self.text_projection.float().T

    def image_features(self, paths, chunk: int = 32) -> torch.Tensor:
        """Image files -> image features [N, P] on the tower's device. Each
        tower call takes `chunk` images, the tail padded with zero rows
        (sliced off after): one set of GEMM shapes, so that a feature does
        not depend on N, and bounded memory for reference sets of thousands
        of images."""
        from PIL import Image

        from ..models.clip_vision import preprocess_clip_image

        size = self.vision.config.image_size
        feats = []
        with torch.inference_mode():
            for i in range(0, len(paths), chunk):
                part = paths[i:i + chunk]
                imgs = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in part])
                pix = preprocess_clip_image(imgs, size).astype(np.float32)
                if len(part) < chunk:
                    pix = np.concatenate(
                        [pix, np.zeros((chunk - len(part),) + pix.shape[1:], pix.dtype)])
                out = self.vision(torch.from_numpy(pix).to(self.device))
                f = out.projected if out.projected is not None else out.pooled
                feats.append(f[:len(part)].float())
        return torch.cat(feats)


def load_dual_tower(clip_dir: str, device="cuda") -> DualTower:
    """A transformers ChineseCLIPModel / CLIPModel directory -> its dual
    tower in fp32: the BERT text tower (`load_bert_text`) with
    `text_projection.weight` if the checkpoint has one, and the vision tower
    (`load_clip_vision`), from one read of the checkpoint."""
    from ..checkpoints.load_pretrained import load_bert_text, load_clip_vision, load_state_dict
    from ..pipelines.factory import resolve_device

    dev = resolve_device(device)
    sd = load_state_dict(clip_dir)
    _, text = load_bert_text(clip_dir, device=dev, sd=sd)
    proj = sd.get("text_projection.weight")
    _, vision = load_clip_vision(clip_dir, device=dev, sd=sd)
    return DualTower(text, None if proj is None else proj.float().to(dev), vision, dev)


def demo_dual_tower(device="cuda") -> DualTower:
    """The JAX CLI's demo towers, random from seeds: BERT_TINY (seed 11) and
    a ViT of 64² images in 8² patches, width 32, 2 layers, projected to the
    text width (seed 12); fp32, no text projection."""
    from ..configs.text_encoder import BERT_TINY
    from ..models.bert_text import BertTextEncoder
    from ..models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from ..pipelines.factory import _materialize, resolve_device

    dev = resolve_device(device)
    vcfg = CLIPVisionConfig(image_size=64, patch_size=8, hidden_size=32, num_layers=2,
                            num_heads=2, intermediate_size=64,
                            projection_dim=BERT_TINY.hidden_size)
    with torch.device("meta"):
        text, vision = BertTextEncoder(BERT_TINY), CLIPVisionEncoder(vcfg)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
    return DualTower(_materialize(text, torch.float32, dev, gen(11)), None,
                     _materialize(vision, torch.float32, dev, gen(12)), dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip-dir", help="transformers ChineseCLIPModel / CLIPModel directory")
    ap.add_argument("--demo", action="store_true",
                    help="tiny random dual tower instead of --clip-dir: runs the whole "
                         "CLIP-score / FID path on real image files; the numbers are "
                         "meaningless (random features)")
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--prompts",
                    help="text file, one prompt per image (or a single prompt); "
                         "optional when only --fid-ref is wanted")
    ap.add_argument("--fid-ref", nargs="+",
                    help="reference image files: adds CLIP-FID between --images and this set")
    ap.add_argument("--max-length", type=int, default=52)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.prompts and not args.fid_ref:
        ap.error("need --prompts (CLIP-score) and/or --fid-ref (FID)")
    if not args.demo and not args.clip_dir:
        ap.error("--clip-dir required without --demo")
    prompts = None
    if args.prompts:
        with open(args.prompts) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
        if len(prompts) == 1:
            prompts = prompts * len(args.images)
        if len(prompts) != len(args.images):
            ap.error(f"{len(prompts)} prompts for {len(args.images)} images")

    if args.demo:
        from ..configs.text_encoder import BERT_TINY
        from .generate import make_tokenizer

        towers = demo_dual_tower(args.device)
        tokenize = make_tokenizer(BERT_TINY.vocab_size, DEMO_TEXT_LENGTH)
    else:
        towers = load_dual_tower(args.clip_dir, args.device)
        if prompts is not None:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(args.clip_dir)
            tokenize = lambda texts: tok(  # noqa: E731
                texts, padding="max_length", max_length=args.max_length, truncation=True,
                return_tensors="np")["input_ids"]

    vfeat = towers.image_features(args.images)
    demo_note = {"demo": "random towers: plumbing smoke, not a quality number"}
    if prompts is not None:
        scores = clip_score(towers.text_features(tokenize(prompts)), vfeat).cpu().numpy()
        for path, s in zip(args.images, scores):
            print(f"{s:.4f}  {path}")
        out = {"metric": "CLIP-score", "value": float(scores.mean()), "n": len(scores)}
        print(json.dumps(dict(out, **demo_note) if args.demo else out))
    if args.fid_ref:
        from ..utils.fid import fid_from_features

        ref = towers.image_features(args.fid_ref)
        fid = fid_from_features(vfeat.cpu().numpy(), ref.cpu().numpy())
        out = {"metric": "CLIP-FID", "value": round(fid, 4), "n": len(args.images),
               "n_ref": len(args.fid_ref),
               "note": "CLIP-feature FID (arXiv:2203.06026), NOT comparable to "
                       "InceptionV3-FID numbers such as the paper's"}
        print(json.dumps(dict(out, **demo_note) if args.demo else out))


if __name__ == "__main__":
    main()

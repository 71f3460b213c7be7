"""Segmentation training, the port of plr2_tpu/train/seg_trainer.py (the
reference's vanilla_segmentation/train.py + data_controller.py): trains a
segmenter (`models/segnet.py` `build_segmenter`) on (colour, label) frames
so the full pipeline (BASELINE config 5) can crop objects without
PoseCNN's masks.

Batched steps on random square crops (`frame_crops`, the same NumPy draws
as the JAX package's), per-pixel cross entropy, Adam at optax's defaults
(`parallel.adam`). Train mode is the port's BatchNorm with flax's
running-variance update; for `arch="pspnet"` the PSP channel dropouts'
masks are drawn on the host from a CPU generator seeded by (epoch seed,
step) before the forward, where JAX folds the step into its epoch key. An
f32 step runs with TF32 off (`pipeline.full_f32`) and cuDNN restricted to
deterministic algorithms (`deterministic_convs`). The segmenter lives on
the trainer's device ("cuda" unless the caller asks for another);
frames arrive as NumPy uint8 and are normalised there, `(x / 255 - 0.5) /
0.5`, as the JAX trainer normalises them.

`predict` pads the NORMALISED frame with zeros (grey, not black) up to a
multiple of 32 for the five pool levels and returns the argmax labels of
the frame's own pixels. Checkpoints are `torch.save` files of the
segmenter's state dict (`save_weights` / `load_weights`); the JAX
package's flax files are not read (`models/weights.py`
`segmenter_state_dict` is the bridge).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from plr2_tpu_torch.data.preprocess import normalize_frames
from plr2_tpu_torch.models.segnet import build_segmenter, segmentation_loss
from plr2_tpu_torch.models.weights import init_random_
from plr2_tpu_torch.parallel.data_parallel import adam, deterministic_convs
from plr2_tpu_torch.pipeline import full_f32, resolve_device


def frame_crops(frames, crop: int, batch: int, key: np.random.Generator
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield batches of random (crop x crop) colour / label windows."""
    imgs, labels = [], []
    for fr in frames:
        h, w = fr.label.shape
        r0 = key.integers(0, max(1, h - crop))
        c0 = key.integers(0, max(1, w - crop))
        imgs.append(fr.color[r0:r0 + crop, c0:c0 + crop])
        labels.append(fr.label[r0:r0 + crop, c0:c0 + crop])
        if len(imgs) == batch:
            yield np.stack(imgs), np.stack(labels)
            imgs, labels = [], []
    if imgs:
        yield np.stack(imgs), np.stack(labels)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of a step's dropout masks."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def save_weights(path: str, model: torch.nn.Module) -> str:
    """The segmenter's state dict (on the CPU) to `path`, written to a
    temporary file and renamed over it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({k: v.detach().to("cpu", copy=True)
                for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, path)
    return path


def load_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Copy a `save_weights` file into `model`'s parameters in place."""
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True), strict=True)
    return model


class SegTrainer:
    def __init__(self, num_classes: int = 22, lr: float = 1e-4,
                 crop: int = 128, batch: int = 3, arch: str = "segnet",
                 device="cuda", use_kernels: bool = True):
        self.device = resolve_device(device)
        self.arch = arch
        self.model = build_segmenter(arch, num_classes, device=self.device,
                                     seed=0, use_kernels=use_kernels)
        self.lr = lr
        self.crop = crop
        self.batch = batch

    def init_state(self, seed: int = 0) -> Dict:
        """Weights drawn from `seed` (`models/weights.py` `init_random_`;
        the trainer is built with seed 0's), a fresh Adam and no best loss
        yet."""
        init_random_(self.model, torch.Generator().manual_seed(seed))
        return {"optimizer": adam(self.model, self.lr),
                "best_loss": float("inf")}

    def train_step(self, state: Dict, img: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One Adam step on a normalised batch img (B, H, W, 3) and labels
        (B, H, W); returns the loss (a 0-d tensor, not synchronised).
        `generator` draws the pspnet segmenter's dropout masks."""
        model, opt = self.model, state["optimizer"]
        opt.zero_grad(set_to_none=False)
        model.train()
        try:
            with full_f32(True), deterministic_convs():
                if self.arch == "pspnet":
                    masks = model.draw_dropout_masks(img.shape[0], generator)
                    logits = model(img, masks=masks)
                else:
                    logits = model(img)
                loss = segmentation_loss(logits, labels)
                loss.backward()
        finally:
            model.eval()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, img: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, pixel accuracy) of the eval-mode segmenter."""
        with full_f32(True):
            logits = self.model(img)
        loss = segmentation_loss(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    @torch.no_grad()
    def predict(self, img: torch.Tensor) -> torch.Tensor:
        """Full-frame labels (B, H, W) of normalised frames (B, H, W, 3):
        the frames zero-padded to a multiple of 32 for the five pool /
        unpool levels, the argmax over the frame's own pixels."""
        h, w = img.shape[-3:-1]
        ph = -(-h // 32) * 32 - h
        pw = -(-w // 32) * 32 - w
        x = F.pad(img.to(self.device), (0, 0, 0, pw, 0, ph))
        with full_f32(True):
            logits = self.model(x)
        return logits[:, :h, :w].argmax(-1)

    def train_epoch(self, state: Dict, frames, seed: int = 0,
                    stop_fn=None) -> Dict:
        """One epoch over random crops. `stop_fn` is the graceful-stop hook
        (utils/interrupt.GracefulInterrupt), checked at batch boundaries:
        completed steps are already in the segmenter, nothing partial to
        unwind."""
        rng = np.random.default_rng(seed)
        losses = []
        t0 = time.time()
        order = rng.permutation(len(frames))
        interrupted = False
        for step, (img, labels) in enumerate(frame_crops(
                [frames[i] for i in order], self.crop, self.batch, rng)):
            if stop_fn is not None and stop_fn():
                interrupted = True
                break
            norm = normalize_frames(torch.from_numpy(img).to(self.device))
            lab = torch.from_numpy(labels.astype(np.int64)).to(self.device)
            loss = self.train_step(state, norm, lab, step_generator(seed, step))
            losses.append(float(loss))
        return {**state,
                "last_epoch_loss": (float(np.mean(losses)) if losses
                                    else float("inf")),
                "seconds": time.time() - t0,
                "interrupted": interrupted}

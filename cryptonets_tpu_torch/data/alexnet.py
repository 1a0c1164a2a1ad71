"""AlexNet featurizer for the Caltech-101 data preparation, port of
`cryptonets_tpu/data/alexnet.py`.

The reference's `DataPreprocess CAL` pipeline (ref `GetCAL.cs:86-123`)
resizes each image to 227x227, extracts raw pixels and runs ML.NET's
`DnnFeaturizeImage` AlexNet to a 4096-d feature vector, written as sparse
TSV (`label\\t4096\\tj:v...`).  This module runs the torchvision AlexNet
topology through fc7 (4096-d, after its ReLU) on raw 0-255 RGB floats:

  * `weights_path=` a torchvision-format `alexnet` state_dict, read from a
    local file, gives real features (nothing is downloaded);
  * without it the parameters are seeded-random, drawn from an explicit
    `torch.Generator` on the CPU in the order and with the bounds of
    torch's default initialisation, so a seed gives the reference's
    parameters and the global random state is left alone; the pipeline,
    formats and shapes are the same, the features a structural stand-in;
  * `convert.alexnet_from_numpy` loads the parameters of the reference's
    featurizer (its state_dict as numpy arrays) into this one.

The model runs on `device` (the card unless the caller names another);
convolutions on the card run without TF32, so the features keep float32
precision.  PIL is imported only by `load_image`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


class AlexNetFc7(nn.Module):
    """torchvision's AlexNet through the fc7 ReLU (classifier indices 0-5)."""

    def __init__(self, device=None):
        super().__init__()
        kw = dict(device=device)
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, kernel_size=11, stride=4, padding=2, **kw),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
            nn.Conv2d(64, 192, kernel_size=5, padding=2, **kw),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
            nn.Conv2d(192, 384, kernel_size=3, padding=1, **kw),
            nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, kernel_size=3, padding=1, **kw),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, kernel_size=3, padding=1, **kw),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
        )
        self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(),
            nn.Linear(256 * 6 * 6, 4096, **kw),
            nn.ReLU(inplace=True),
            nn.Dropout(),
            nn.Linear(4096, 4096, **kw),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.flatten(1))


def seeded_model(seed: int = 0) -> AlexNetFc7:
    """The model on the CPU with parameters drawn from a generator seeded
    with `seed`: per layer in construction order, the weight uniform in
    +-sqrt(6 / ((1 + 5) fan_in)) (kaiming_uniform_ at a = sqrt(5)), then the
    bias uniform in +-1 / sqrt(fan_in), as `reset_parameters` draws them."""
    model = AlexNetFc7(device="meta").to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = math.sqrt(2.0 / (1 + 5))
                bound = math.sqrt(3.0) * gain / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=gen)
                b = 1 / math.sqrt(fan_in)
                m.bias.uniform_(-b, b, generator=gen)
    return model


class AlexNetFeaturizer:
    """227x227 RGB images -> 4096-d fc7 features (ref DnnFeaturizeImage)."""

    def __init__(self, weights_path: str | None = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        model = seeded_model(seed)
        self.pretrained = False
        if weights_path:
            state = torch.load(weights_path, map_location="cpu",
                               weights_only=True)
            # torchvision's state_dict has classifier.{1,4,6}; fc8 is dropped
            model.load_state_dict({k: v for k, v in state.items()
                                   if not k.startswith("classifier.6")})
            self.pretrained = True
        self.model = model.to(self.device).eval()

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: uint8/float [B, 227, 227, 3] (HWC RGB) -> float32 [B, 4096]."""
        x = np.asarray(images, dtype=np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.shape[1:] != (227, 227, 3):
            raise ValueError(f"images must be [B, 227, 227, 3]: {x.shape}")
        x = torch.from_numpy(x.transpose(0, 3, 1, 2))   # NCHW, raw 0-255
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False):
            out = self.model(x.to(self.device))
        return out.cpu().numpy()


def load_image(path: str) -> np.ndarray:
    """Load + resize to 227x227 RGB (ref ResizeImages 227x227)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((227, 227)))


def write_sparse_tsv(fh, label: int, feats: np.ndarray) -> None:
    """One record in the reference's sparse line format
    (`GetCAL.cs:113-118`): label\\t4096\\tj:v for nonzero j."""
    parts = [str(int(label)), str(len(feats))]
    parts += [f"{j}:{feats[j]:g}" for j in np.nonzero(feats)[0]]
    fh.write("\t".join(parts) + "\n")


def featurize_directory(
    src_dir: str, out_path: str, weights_path: str | None = None,
    limit_per_class: int | None = None, seed: int = 0, device=None,
) -> int:
    """Walk <src_dir>/<class>/<image> (the 101_ObjectCategories layout),
    featurize, and write the sparse TSV the readers consume.  Returns the
    number of records written."""
    feat = AlexNetFeaturizer(weights_path, seed=seed, device=device)
    classes = sorted(d for d in os.listdir(src_dir)
                     if os.path.isdir(os.path.join(src_dir, d)))
    n = 0
    with open(out_path, "w") as fh:
        for label, cls in enumerate(classes):
            files = sorted(os.listdir(os.path.join(src_dir, cls)))
            if limit_per_class:
                files = files[:limit_per_class]
            for f in files:
                img = load_image(os.path.join(src_dir, cls, f))
                write_sparse_tsv(fh, label, feat(img)[0])
                n += 1
    return n

"""Image data pipeline: directory datasets + deterministic synthetic data.

The port's own copy of ``llicti_tpu/data/dataset.py``: the same
functions and classes, so that the same seed, epoch and step give the
same bytes in both packages.  A light-weight threaded prefetch pipeline
feeds numpy float32 batches on the host; the trainer uploads them to the
card.  Semantics kept from the reference (dataloaders/image_dl.py:16-111):

* train: random crop (patch_size) + random horizontal flip (NO vertical
  flip), images smaller than the crop upscaled to fit;
* eval: center crop (val_patch_size) or full image when size==0;
* patches_per_img > 1 stacks multiple random crops per image.

A synthetic dataset (gradients+texture+noise, seeded) needs no image files
and no PIL; decoding image files needs PIL.  Unlike the JAX package's,
:func:`list_images` and :func:`load_rgb` also take a uint8 H×W×3 ``.npy``
array, the file both packages' decoders write where PIL is missing.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

try:  # decoding image files needs PIL; the synthetic data set does not
    from PIL import Image

    _HAS_PIL = True
except ImportError:
    _HAS_PIL = False

_EXTS = (".png", ".jpg", ".jpeg", ".npy")


def list_images(roots: Sequence[str]) -> List[str]:
    files: List[str] = []
    for root in roots:
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"Dataset dir not found (drive unmounted?): {root}")
        files += [os.path.join(root, f) for f in sorted(os.listdir(root))
                  if f.lower().endswith(_EXTS)]
    return files


def load_rgb(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3] RGB: PNG / JPEG through PIL, or a
    uint8 [H, W, 3] ``.npy`` array as it is."""
    if path.lower().endswith(".npy"):
        img = np.load(path, allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{path}: expected a uint8 [H, W, 3] array, "
                             f"got {img.dtype} {img.shape}")
        return img
    if not _HAS_PIL:
        raise RuntimeError(
            f"cannot decode {path}: PIL is not installed (the synthetic "
            "data set needs no PIL)")
    with open(path, "rb") as f:
        img = Image.open(f)
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """Natural-ish deterministic image: smooth fields + texture + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f1, f2, f3 = rng.uniform(9, 31, 3)
    ph = rng.uniform(0, 6.28, 4)
    base = (
        120
        + 70 * np.sin(yy / f1 + ph[0]) * np.cos(xx / f2 + ph[1])
        + 45 * np.sin((xx + yy) / f3 + ph[2])
    )
    tex = 10 * np.sin(xx * 1.3 + ph[3]) * np.sin(yy * 1.7)
    img = np.stack(
        [base + tex, 0.85 * base + 25 + tex, 0.7 * base + 45], axis=-1)
    img = img + rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_natural_image(h: int, w: int, seed: int) -> np.ndarray:
    """Multi-octave value-noise image with photographic-like statistics.

    Natural images have ~1/f power spectra, correlated color channels,
    and sharp edges; sinusoid synthetics (synthetic_image above) have
    none of these, which is why models trained on them saturate at a
    noise floor.  This generator sums bilinear-upsampled random grids
    with geometrically decaying amplitude (the 1/f part), modulates
    chroma at low amplitude around a shared luma (channel correlation),
    and overlays a few random step edges (edge content).
    """
    rng = np.random.default_rng(seed)
    n_oct = int(np.log2(min(h, w))) - 1

    def octave_field():
        acc = np.zeros((h, w), np.float32)
        amp = 1.0
        for o in range(n_oct, -1, -1):
            gh, gw = max(2, h >> o), max(2, w >> o)
            grid = rng.standard_normal((gh, gw)).astype(np.float32)
            yi = np.linspace(0, gh - 1, h, dtype=np.float32)
            xi = np.linspace(0, gw - 1, w, dtype=np.float32)
            y0 = np.clip(yi.astype(np.int64), 0, gh - 2)
            x0 = np.clip(xi.astype(np.int64), 0, gw - 2)
            fy = (yi - y0)[:, None]
            fx = (xi - x0)[None, :]
            g = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
                 + grid[y0 + 1][:, x0] * fy * (1 - fx)
                 + grid[y0][:, x0 + 1] * (1 - fy) * fx
                 + grid[y0 + 1][:, x0 + 1] * fy * fx)
            acc += amp * g
            amp *= rng.uniform(0.45, 0.65)
        return acc

    luma = octave_field()
    luma = (luma - luma.mean()) / (luma.std() + 1e-6)
    # random step edges from oriented half-planes at multiple strengths
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(int(rng.integers(2, 7))):
        th = rng.uniform(0, np.pi)
        d = ((xx - rng.uniform(0, w)) * np.cos(th)
             + (yy - rng.uniform(0, h)) * np.sin(th))
        luma += rng.uniform(-0.8, 0.8) * (d > 0)
    luma = (luma - luma.mean()) / (luma.std() + 1e-6)
    chroma_u = octave_field()
    chroma_v = octave_field()
    base = 110 + rng.uniform(-30, 30)
    contrast = rng.uniform(28, 60)
    cu = rng.uniform(3, 18) * chroma_u / (chroma_u.std() + 1e-6)
    cv = rng.uniform(3, 18) * chroma_v / (chroma_v.std() + 1e-6)
    r = base + contrast * luma + cu
    g = base + contrast * luma - 0.5 * cu + 0.5 * cv
    b = base + contrast * luma - cv
    img = np.stack([r, g, b], axis=-1)
    img += rng.normal(0, rng.uniform(0.5, 2.5), img.shape)  # sensor noise
    return np.clip(img, 0, 255).astype(np.uint8)


class ImageDataset:
    """Random-access dataset of [H, W, 3] uint8 images.

    Decoded images are cached in RAM by default (the corpus is tens of
    images, and decoding them again every epoch would hold the train step
    back); synthetic images are made anew on every ``get``.
    """

    def __init__(
        self,
        roots: Sequence[str] = (),
        synthetic_len: int = 0,
        synthetic_size: int = 256,
        seed: int = 0,
        cache: bool = True,
        cache_max_images: int = 2048,
    ):
        self.files = list_images(roots) if roots else []
        self.synthetic_len = synthetic_len
        self.synthetic_size = synthetic_size
        self.seed = seed
        self._cache: Optional[dict] = (
            {} if cache and len(self.files) <= cache_max_images else None)
        self._cache_lock = threading.Lock()
        if not self.files and not synthetic_len:
            raise ValueError("empty dataset: no roots and no synthetic_len")

    def __len__(self) -> int:
        return len(self.files) or self.synthetic_len

    def get(self, i: int) -> np.ndarray:
        if self.files:
            if self._cache is not None:
                with self._cache_lock:
                    img = self._cache.get(i)
                if img is None:
                    img = load_rgb(self.files[i])
                    with self._cache_lock:
                        self._cache[i] = img
                return img
            return load_rgb(self.files[i])
        return synthetic_image(self.synthetic_size, self.synthetic_size,
                               self.seed * 1_000_003 + i)


def _resize_to_fit(img: np.ndarray, min_h: int, min_w: int) -> np.ndarray:
    """Upscale (nearest) so both dims are >= the crop size.

    Reference uses PIL ImageOps.fit (image_dl.py:85-97); nearest keeps the
    8-bit distribution intact which matters for a lossless codec.
    """
    h, w = img.shape[:2]
    if h >= min_h and w >= min_w:
        return img
    sh = max(1.0, min_h / h)
    sw = max(1.0, min_w / w)
    s = max(sh, sw)
    nh, nw = int(np.ceil(h * s)), int(np.ceil(w * s))
    ri = (np.arange(nh) * h // nh).astype(np.int64)
    ci = (np.arange(nw) * w // nw).astype(np.int64)
    return img[ri][:, ci]


def random_patch(img: np.ndarray, size: int, rng: np.random.Generator,
                 hflip: bool = True) -> np.ndarray:
    img = _resize_to_fit(img, size, size)
    h, w = img.shape[:2]
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    patch = img[y:y + size, x:x + size]
    if hflip and rng.random() < 0.5:
        patch = patch[:, ::-1]
    return np.ascontiguousarray(patch)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    if size == 0:
        return img
    img = _resize_to_fit(img, size, size)
    h, w = img.shape[:2]
    y = (h - size) // 2
    x = (w - size) // 2
    return np.ascontiguousarray(img[y:y + size, x:x + size])


class TrainLoader:
    """Shuffled, threaded-prefetch batches of random patches.

    Yields float32 [acc, B, P, P, 3] in [0, 1] per optimizer step, where
    acc = grad_acc_iters (the microbatch axis the train step loops
    over).
    """

    def __init__(self, dataset: ImageDataset, batch_size: int,
                 patch_size: int, grad_acc: int = 1, patches_per_img: int = 1,
                 seed: int = 1337, num_threads: int = 2,
                 prefetch: int = 4):
        self.ds = dataset
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.grad_acc = grad_acc
        self.patches_per_img = patches_per_img
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0

    def steps_per_epoch(self) -> int:
        n_patches = len(self.ds) * self.patches_per_img
        return max(1, n_patches // (self.batch_size * self.grad_acc))

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(len(self.ds))
        if self.patches_per_img > 1:
            order = np.repeat(order, self.patches_per_img)
            order = rng.permutation(order)
        bs = self.batch_size * self.grad_acc
        n_steps = len(order) // bs

        def make_batch(s: int) -> np.ndarray:
            # batch content is keyed only by (seed, epoch, s): identical
            # regardless of how many threads build it (reference uses
            # dl_numworkers torch DataLoader workers, image_dl.py:33-39)
            idxs = order[s * bs:(s + 1) * bs]
            srng = np.random.default_rng((self.seed, self.epoch, s))
            patches = [
                random_patch(self.ds.get(int(i)), self.patch_size, srng)
                for i in idxs
            ]
            batch = np.stack(patches).astype(np.float32) / 255.0
            return batch.reshape(self.grad_acc, self.batch_size,
                                 self.patch_size, self.patch_size, 3)

        window = self.prefetch + max(1, self.num_threads)
        if n_steps:
            with ThreadPoolExecutor(max(1, self.num_threads)) as pool:
                futs = {s: pool.submit(make_batch, s)
                        for s in range(min(window, n_steps))}
                for s in range(n_steps):
                    batch = futs.pop(s).result()
                    nxt = s + window
                    if nxt < n_steps:
                        futs[nxt] = pool.submit(make_batch, nxt)
                    yield batch
        self.epoch += 1


class EvalLoader:
    """Sequential full/center-cropped images (reference test/valid loaders,
    image_dl.py:40-51).  ``batch_size`` > 1 stacks consecutive same-shape
    images (the reference's val loader honors val_batch_size with a fixed
    CenterCrop; with full-size ragged images we flush at shape changes
    instead of crashing like torch's default collate would)."""

    def __init__(self, dataset: ImageDataset, patch_size: int = 0,
                 batch_size: int = 1):
        self.ds = dataset
        self.patch_size = patch_size
        self.batch_size = max(1, batch_size)

    def __iter__(self):
        buf: List[np.ndarray] = []
        for i in range(len(self.ds)):
            img = center_crop(self.ds.get(i), self.patch_size)
            if buf and buf[0].shape != img.shape:
                yield np.stack(buf).astype(np.float32) / 255.0
                buf = []
            buf.append(img)
            if len(buf) == self.batch_size:
                yield np.stack(buf).astype(np.float32) / 255.0
                buf = []
        if buf:
            yield np.stack(buf).astype(np.float32) / 255.0

    def iter_uint8(self):
        for i in range(len(self.ds)):
            yield center_crop(self.ds.get(i), self.patch_size)

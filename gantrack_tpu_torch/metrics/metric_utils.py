"""Feature passes shared by the quality metrics (PyTorch).

Port of ``gantrack_tpu/metrics/metric_utils.py``: ``MetricOptions``,
detectors, the dataset pass (with the per-batch uint8 shim and the
md5-keyed feature cache) and the generator pass.

With ``opts.mesh`` of a process group, each batch of both passes is
split over the ranks (padded to a multiple of the world by repeating
its last row, as JAX's ``Detector.sharded`` pads), each rank runs its
rows and the features are all-gathered in order before the statistics,
so N ranks give one rank's features.  JAX rounds the generator pass's
batch up to a multiple of the mesh instead; the port keeps the batch,
so the z stream does not depend on the number of ranks.  The uint8
shim decides on the maximum of the whole batch (reduced over ranks).
Only rank 0 writes the feature cache.

* A :class:`Detector` takes images ``[N, 3, H, W]`` (float, 0..255) on
  its device and returns ``[N, D]`` float32 features there.
* The generator pass runs on the device under ``torch.inference_mode()``:
  z from a ``torch.Generator`` seeded by ``opts.seed`` (drawn by
  :func:`sample_z`, which tests replace to replay another z-stream),
  G_ema, ``floor(clamp(img · 127.5 + 128, 0, 255))`` (the reference's
  uint8 truncation), 1 → 3 channels, the detector; only the features
  come back to the host.
* Statistics accumulate on the host in float64 (``feature_stats``), and
  FID's ``sqrtm`` is scipy host work, as in the JAX package.

The generator pass marks its batches with spans (:mod:`..utils.profiling`),
each with the pass's ``opts.seed`` as ``seed``: ``metric.generate`` (the
generator callable), ``metric.detect`` (the detector), ``metric.fetch``
(the features' copy to the host, which waits for the device) and, in
``FeatureStats.append``, ``metric.sums``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.inception import bilinear_resize
from ..utils.profiling import span
from ..parallel.mesh import Mesh
from .feature_stats import FeatureStats, cache_path

# Names the dataset pass's uint8 shim (``dataset_uint8_shim``) in the
# feature-cache key: change it whenever the shim changes.
SHIM_TOKEN = "uint8-shim-v1:unit-floats-x255-truncated;exact-255-and-0..255-pass"


@dataclasses.dataclass
class MetricOptions:
    """Everything a metric needs."""

    generator: Optional[Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]] = None
    #   generator(z, c) -> images [N, C, H, W] in [-1, 1] on ``device``
    generator_with_transform: Optional[Callable] = None
    #   generator_with_transform(z, c, transform_3x3) -> images: synthesis with the user
    #   transform of StyleGAN3's input set (the equivariance metrics)
    mapping: Optional[Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]] = None
    #   mapping(z, c) -> ws [N, num_ws, w_dim]  (needed by w-space PPL)
    synthesis: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    #   synthesis(ws) -> images [N, C, H, W] in [-1, 1]  (needed by w-space PPL)
    z_dim: int = 512
    c_dim: int = 0
    dataset: Any = None
    detector: Optional["Detector"] = None
    mode_idx: Optional[int] = None  # the modality of 2-channel data
    num_items: Optional[int] = None
    batch_size: int = 64
    cache_dir: Optional[str] = None
    seed: int = 0
    progress: Optional[Callable[[int, int], None]] = None
    device: torch.device = torch.device("cpu")
    mesh: Optional[Mesh] = None  # split the feature passes over a process group


def _split(opts: MetricOptions) -> Optional[Mesh]:
    return opts.mesh if opts.mesh is not None and opts.mesh.distributed else None


def rank_rows(mesh: Mesh, n: int) -> List[int]:
    """The rows of an ``n``-row batch that ``mesh.rank`` runs: an equal
    contiguous share of ``n`` padded up to a multiple of the world with
    copies of the last row."""
    per = -(-n // mesh.world)
    return [min(i, n - 1) for i in range(mesh.rank * per, (mesh.rank + 1) * per)]


def gather_rows(mesh: Mesh, feats: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's ``feats`` (of :func:`rank_rows`) in rank order, the
    padding dropped: the features of the whole ``n``-row batch."""
    parts = [torch.empty_like(feats) for _ in range(mesh.world)]
    dist.all_gather(parts, feats.contiguous())
    return torch.cat(parts)[:n]


def auto_metric_batch(resolution: int, floor: int = 32, cap: int = 256) -> int:
    """Feature-extraction batch for an image resolution (the JAX rule):
    256 at 256², halved per doubling of the resolution."""
    b = (256 * 256 * 256) // max(resolution * resolution, 1)
    return int(min(cap, max(floor, b)))


class Detector:
    """``fn`` on the device: images ``[N, 3, H, W]`` (0..255) → ``[N, D]``."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], name: str,
                 device: torch.device):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.fn(images.to(self.device, torch.float32)).float()


def make_random_projection_detector(seed: int = 0, dim: int = 512,
                                    scales: Sequence[int] = (32, 16, 8),
                                    device: torch.device = torch.device("cpu"),
                                    matrices: Optional[List[torch.Tensor]] = None) -> Detector:
    """The no-weights detector: multi-scale downsampled pixels (HWC
    order, as the JAX detector flattens them) through fixed Gaussian
    matrices.  Relative FID/KID comparisons stay meaningful; absolute
    values are not comparable to Inception FID.  The matrices come from a
    CPU ``torch.Generator`` seeded by ``seed`` (or are given, e.g. the
    JAX detector's through ``bridge.random_projection_from_jax``); they
    differ from JAX's, so the name does too and the caches never mix."""
    per = dim // len(scales)
    if matrices is None:
        gen = torch.Generator().manual_seed(seed)
        matrices = [torch.randn((s * s * 3, per), generator=gen) / np.sqrt(s * s * 3)
                    for s in scales]
    mats = [m.to(device, torch.float32) for m in matrices]

    def fn(imgs: torch.Tensor) -> torch.Tensor:
        feats = []
        for mat, s in zip(mats, scales):
            x = bilinear_resize(imgs, s, s).permute(0, 2, 3, 1)
            feats.append((x.reshape(x.shape[0], -1) / 127.5 - 1.0) @ mat)
        return torch.cat(feats, dim=1)

    return Detector(fn, f"randproj-torch-{dim}-seed{seed}", device)


def _resolve_weights(weights_path: Optional[str]) -> Optional[str]:
    """A local path, a ``file://`` URL or an http(s) URL of detector weights
    → a local path, through ``utils.url`` (its cache and
    ``GANTRACK_URL_MIRROR`` first), as ``gantrack_tpu/metrics/metric_utils.py``
    resolves them (reference ``metric_utils.py:47-58``)."""
    if weights_path:
        from ..utils.url import is_url, open_url

        if is_url(weights_path, allow_file_urls=True):
            return open_url(weights_path, return_filename=True, verbose=False)
    return weights_path


def make_inception_detector(weights_path: Optional[str] = None, seed: int = 0,
                            device: torch.device = torch.device("cpu")) -> Detector:
    """InceptionV3 from converted weights (an ``.npz`` of
    ``tools/convert_detector.py``: a path or URL); with no weights given,
    the random projection detector."""
    weights_path = _resolve_weights(weights_path)
    if not weights_path:
        return make_random_projection_detector(seed=seed, device=device)
    if not os.path.isfile(weights_path):
        raise FileNotFoundError(f"detector weights {weights_path!r} not found")
    from ..models import inception

    model = inception.load_npz(weights_path, device=device)
    return Detector(model, f"inception-{model.variant}:{os.path.basename(weights_path)}",
                    device)


def make_vgg_detector(weights_path: Optional[str] = None, seed: int = 0,
                      device: torch.device = torch.device("cpu"),
                      resize_to: int = 224) -> Detector:
    """VGG16's 4096-d ``fc2`` embedding (precision/recall, PPL) from
    converted weights (an ``.npz``: a path or URL), or from seeded random
    weights without them."""
    from ..models import vgg

    weights_path = _resolve_weights(weights_path)
    if weights_path:
        if not os.path.isfile(weights_path):
            raise FileNotFoundError(f"VGG16 weights {weights_path!r} not found")
        model = vgg.load_npz(weights_path, resize_to=resize_to, device=device)
        name = f"vgg16:{os.path.basename(weights_path)}"
    else:
        model = vgg.random_vgg(seed, resize_to=resize_to, device=device)
        name = f"vgg16-torch:random-seed{seed}"
    return Detector(model, name, device)


def to_detector_input(images: torch.Tensor, mode_idx: Optional[int]) -> torch.Tensor:
    """Channel select and 1 → 3 repeat of NCHW images in 0..255."""
    if mode_idx is not None:
        images = images[:, mode_idx:mode_idx + 1]
    c = images.shape[1]
    if c == 1:
        images = images.repeat(1, 3, 1, 1)
    elif c == 2:
        raise ValueError("select a modality (mode_idx) for multimodal data")
    return images


_warned_unshimmed: list = []  # once-per-process flag for the shim warning


def dataset_uint8_shim(batch: np.ndarray, bmax: Optional[float] = None) -> np.ndarray:
    """The per-batch uint8 shim of the dataset pass (JAX
    ``metric_utils.py:239-264``): a batch of [0, 1] floats is scaled by
    255 and truncated to uint8, as the reference does; a batch with an
    exact 255 passes through; a [0, 255] float batch without one passes
    through too (the reference would saturate it), with a warning once.
    ``bmax`` is the whole batch's maximum where ``batch`` is a part."""
    bmax = float(batch.max()) if bmax is None else bmax
    if bmax != 255 and bmax <= 1.001:
        return np.clip(batch * 255, 0, 255).astype(np.uint8).astype(np.float32)
    if bmax != 255 and not _warned_unshimmed:
        _warned_unshimmed.append(True)
        warnings.warn(
            f"metric batch max={bmax:.3f}: [0,255]-ranged floats without an exact 255; "
            "the reference's *255 -> uint8 shim would saturate such batches, so they pass "
            "through unchanged (warned once)", stacklevel=2)
    return batch


def compute_feature_stats_for_dataset(opts: MetricOptions, capture_all: bool = False,
                                      capture_mean_cov: bool = False,
                                      max_items: Optional[int] = None) -> FeatureStats:
    """Features over real data, with the feature cache."""
    dataset = opts.dataset
    n = len(dataset) if max_items is None else min(len(dataset), max_items)

    cache_file = None
    if opts.cache_dir is not None:
        cache_file = cache_path(
            opts.cache_dir, "features", shim=SHIM_TOKEN,
            dataset=getattr(dataset, "_path", dataset.name), detector=opts.detector.name,
            mode_idx=opts.mode_idx, capture_all=capture_all,
            capture_mean_cov=capture_mean_cov, max_items=max_items)
        if os.path.isfile(cache_file):
            return FeatureStats.load(cache_file)

    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov, max_items=n)
    mesh = _split(opts)
    idx = 0
    while not stats.is_full():
        k = min(opts.batch_size, n - idx)
        if k <= 0:
            break
        rows = range(k) if mesh is None else rank_rows(mesh, k)
        batch = np.stack([dataset[(idx + j) % len(dataset)][0] for j in rows])  # NHWC
        idx += k
        bmax = None
        if mesh is not None:
            top = torch.tensor(float(batch.max()), device=opts.detector.device)
            dist.all_reduce(top, op=dist.ReduceOp.MAX)
            bmax = float(top)
        batch = dataset_uint8_shim(batch, bmax)
        x = torch.from_numpy(np.ascontiguousarray(batch.transpose(0, 3, 1, 2)))
        x = to_detector_input(x.to(opts.detector.device, non_blocking=True), opts.mode_idx)
        feats = opts.detector(x)
        if mesh is not None:
            feats = gather_rows(mesh, feats, k)
        stats.append(feats.cpu().numpy())
        if opts.progress:
            opts.progress(stats.num_items, n)

    if cache_file is not None and (mesh is None or mesh.is_main):
        stats.save(cache_file)
    return stats


def sample_z(generator: torch.Generator, n: int, z_dim: int,
             device: torch.device) -> torch.Tensor:
    """z of one batch of the generator pass."""
    return torch.randn((n, z_dim), generator=generator, device=device)


def compute_feature_stats_for_generator(opts: MetricOptions, capture_all: bool = False,
                                        capture_mean_cov: bool = False,
                                        max_items: Optional[int] = None) -> FeatureStats:
    """Features over generated data: z → G_ema → uint8 truncation →
    detector, on the device; labels (conditional G) from the dataset's
    empirical distribution, else uniform classes."""
    assert opts.generator is not None
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov,
                         max_items=max_items)
    device = torch.device(opts.device)
    gen = torch.Generator(device=device).manual_seed(opts.seed)
    label_rng = np.random.default_rng(opts.seed)
    bs = opts.batch_size
    mesh = _split(opts)
    rows = None if mesh is None else torch.tensor(rank_rows(mesh, bs), device=device)
    with torch.inference_mode():
        while not stats.is_full():
            c = None
            if opts.c_dim > 0:
                if opts.dataset is not None and opts.dataset.has_labels:
                    ids = label_rng.integers(0, len(opts.dataset), bs)
                    labels = np.stack([opts.dataset.get_label(int(i)) for i in ids])
                else:
                    labels = np.eye(opts.c_dim, dtype=np.float32)[
                        label_rng.integers(0, opts.c_dim, bs)]
                c = torch.from_numpy(labels.astype(np.float32)).to(device)
            z = sample_z(gen, bs, opts.z_dim, device)
            if rows is not None:
                z, c = z[rows], (None if c is None else c[rows])
            with span("metric.generate", seed=opts.seed):
                img = opts.generator(z, c)
            img = torch.floor(torch.clamp(img.float() * 127.5 + 128, 0, 255))
            with span("metric.detect", seed=opts.seed):
                feats = opts.detector(to_detector_input(img, opts.mode_idx))
            if mesh is not None:
                feats = gather_rows(mesh, feats, bs)
            with span("metric.fetch", seed=opts.seed):
                feats = feats.cpu().numpy()
            stats.append(feats)
            if opts.progress and stats.max_items:
                opts.progress(stats.num_items, stats.max_items)
    return stats

# Copies of worddiffusion_tpu/eval/fid.py's numpy functions: the port imports nothing of the JAX package.
"""FID harness (port of ``worddiffusion_tpu/eval/fid.py``).

``gaussian_stats``, ``frechet_distance``, ``compute_features``,
``fid_score`` and ``phosc_resize`` are copies (numpy, scipy);
``load_phosc_net`` and ``phosc_featurizer`` run the port's ``PHOSCNet`` on
a JAX-layout pickle (``models.convert.read_params_pickle``). The Frechet
distance is exact; the features are the trained recognizer's pooled trunk
vector (the JAX package's default FID protocol), which is not comparable
with published Inception-FID numbers: use it for relative comparisons.
The Inception featurizer (``eval/inception.py``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from scipy import linalg


def gaussian_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def compute_features(
    apply_fn: Callable[[np.ndarray], np.ndarray],
    batches: Iterable[np.ndarray],
) -> np.ndarray:
    out = [np.asarray(apply_fn(b)) for b in batches]
    return np.concatenate(out, axis=0)


def fid_score(
    real_feats: np.ndarray, fake_feats: np.ndarray
) -> float:
    """Exact FID from raw feature matrices WITHOUT forming [D, D]
    covariances. With sample covariances S1 = Y'Y/(n1-1),
    S2 = X'X/(n2-1) (Y, X mean-centered), the nonzero eigenvalues of
    S1·S2 equal the squared singular values of X·Y'/sqrt((n1-1)(n2-1))
    (cyclic permutation), so

        tr((S1·S2)^0.5) = sum svdvals(X·Y') / sqrt((n1-1)(n2-1))

    — an [n2, n1] SVD instead of scipy.linalg.sqrtm on [D, D]. At the
    4096-d PHOSC features this is seconds vs ~10 minutes on this host,
    and numerically cleaner (sqrtm of the non-symmetric product drifts
    complex; singular values are nonnegative by construction)."""
    real_feats = np.asarray(real_feats, np.float64)
    fake_feats = np.asarray(fake_feats, np.float64)
    n1, n2 = len(real_feats), len(fake_feats)
    if min(n1, n2) < 2:
        raise ValueError("FID needs >=2 samples per side")
    mu1 = real_feats.mean(axis=0)
    mu2 = fake_feats.mean(axis=0)
    y = real_feats - mu1
    x = fake_feats - mu2
    diff = mu1 - mu2
    tr1 = float((y * y).sum()) / (n1 - 1)   # tr(S1)
    tr2 = float((x * x).sum()) / (n2 - 1)   # tr(S2)
    cross = x @ y.T / np.sqrt((n1 - 1) * (n2 - 1))
    tr_covmean = float(np.linalg.svd(cross, compute_uv=False).sum())
    return float(diff @ diff + tr1 + tr2 - 2.0 * tr_covmean)


def phosc_resize(images: np.ndarray) -> np.ndarray:
    """[-1,1] float images at any HxW -> the recognizer's 50x250,
    still [-1,1] (shared by the FID featurizer and the ZSL path in
    ``cli/evaluate`` so the two can never drift)."""
    from ..utils.images import resize_and_pad

    images = np.asarray(images)
    if images.shape[1:3] != (50, 250):
        images = np.stack([
            resize_and_pad(
                ((c + 1.0) / 2.0 * 255.0).astype(np.uint8), 50, 250
            ).astype(np.float32) / 127.5 - 1.0
            for c in images
        ])
    return images


def load_phosc_net(params_path: str, language: str = "eng", trunk: str = "vgg",
                   device: str | torch.device = "cuda"):
    """-> (``im [B, 50, 250, 3] in [-1, 1] -> {"phos", "phoc", "features"}``,
    the model): a JAX-layout pickle loaded into the port's PHOSCNet (bf16
    compute, fp32 parameters) on ``device``, evaluated under no_grad."""
    from ..data.alphabets import phoc_dim, phos_dim
    from ..models.convert import jax_phoscnet_to_torch, read_params_pickle, state_dict_to_torch
    from ..models.phoscnet import PHOSCNet

    device = torch.device(device)
    net = PHOSCNet(phos_size=phos_dim(language), phoc_size=phoc_dim(language), trunk=trunk)
    net.load_state_dict(state_dict_to_torch(jax_phoscnet_to_torch(
        read_params_pickle(params_path))))
    net = net.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)

    def fn(im) -> dict:
        with torch.no_grad():
            return net(torch.as_tensor(im, device=device), return_features=True)

    return fn, net


def phosc_featurizer(params_path: str, language: str = "eng", trunk: str = "vgg",
                     device: str | torch.device = "cuda"):
    """Trained-PHOSCNet TPP-feature extractor, the default FID protocol:
    ``apply_fn(images [B, H, W, 3] in [-1, 1]) -> [B, D]`` numpy; inputs are
    resized to the recognizer's 50x250 on the host."""
    fn, _ = load_phosc_net(params_path, language, trunk, device)

    def apply_fn(images: np.ndarray) -> np.ndarray:
        return fn(phosc_resize(images))["features"].cpu().numpy()

    return apply_fn

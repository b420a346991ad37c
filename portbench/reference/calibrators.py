"""The four PTQ calibrators (min-max, percentile, MSE, entropy), frozen.

A copy of the serving program's calibrators as they stood when this
benchmark was written, so that the reference computes its activation
scales from its own code: a later change to the program's calibration
cannot move the yardstick. The histogram machinery is numpy in float64.
"""
from __future__ import annotations

import numpy as np

INT8_MAX = 127
EPS = 1e-8


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().to("cpu").float().numpy()
    return np.asarray(x, dtype=np.float32)


class Calibrator:
    """Base class. Subclasses implement observe()/compute_amax()."""

    name = "base"

    def observe(self, x) -> None:
        raise NotImplementedError

    def compute_amax(self) -> float:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class MinMaxCalibrator(Calibrator):
    """Running max of |x| — the paper's Table 2 calibrator ("min-max")."""

    name = "minmax"

    def __init__(self):
        self._amax = 0.0

    def observe(self, x) -> None:
        self._amax = max(self._amax, float(np.max(np.abs(_host(x)))))

    def compute_amax(self) -> float:
        return max(self._amax, EPS)

    def reset(self) -> None:
        self._amax = 0.0


class _HistogramCalibrator(Calibrator):
    """Shared histogram machinery (pytorch-quantization style): ``num_bins``
    bins over [0, range]; a batch that exceeds the range re-bins the old
    counts into the wider histogram."""

    def __init__(self, num_bins: int = 2048):
        self.num_bins = int(num_bins)
        self._hist = np.zeros(self.num_bins, dtype=np.float64)
        self._range = 0.0

    def reset(self) -> None:
        self._hist[:] = 0.0
        self._range = 0.0

    def observe(self, x) -> None:
        ax = np.abs(_host(x)).ravel()
        batch_max = float(ax.max()) if ax.size else 0.0
        if batch_max == 0.0:
            return
        if batch_max > self._range:
            if self._range > 0.0:
                old_edges = np.linspace(0.0, self._range, self.num_bins + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2.0
                new_hist, _ = np.histogram(
                    centers, bins=self.num_bins, range=(0.0, batch_max),
                    weights=self._hist)
                self._hist = new_hist
            self._range = batch_max
        counts, _ = np.histogram(ax, bins=self.num_bins,
                                 range=(0.0, self._range))
        self._hist += counts

    def _bin_edges(self) -> np.ndarray:
        return np.linspace(0.0, self._range, self.num_bins + 1)


class PercentileCalibrator(_HistogramCalibrator):
    """amax = the value below which ``percentile``% of |x| mass falls."""

    name = "percentile"

    def __init__(self, percentile: float = 99.99, num_bins: int = 2048):
        super().__init__(num_bins)
        if not 0.0 < percentile <= 100.0:
            raise ValueError(
                f"percentile must be in (0, 100], got {percentile}")
        self.percentile = float(percentile)

    def compute_amax(self) -> float:
        total = self._hist.sum()
        if total == 0:
            return EPS
        cdf = np.cumsum(self._hist) / total
        idx = int(np.searchsorted(cdf, self.percentile / 100.0))
        idx = min(idx, self.num_bins - 1)
        return float(self._bin_edges()[idx + 1])


class MSECalibrator(_HistogramCalibrator):
    """amax minimizing E[(x - QDQ(x))^2], searched over candidate clips."""

    name = "mse"

    def __init__(self, num_bins: int = 2048, num_candidates: int = 64):
        super().__init__(num_bins)
        self.num_candidates = int(num_candidates)

    def compute_amax(self) -> float:
        total = self._hist.sum()
        if total == 0:
            return EPS
        edges = self._bin_edges()
        centers = (edges[:-1] + edges[1:]) / 2.0
        best_amax, best_mse = self._range, np.inf
        # log-spaced clipping candidates: heavy-tailed distributions want
        # amax orders of magnitude below max|x|
        for frac in np.geomspace(1e-4, 1.0, self.num_candidates):
            amax = frac * self._range
            scale = max(amax, EPS) / INT8_MAX
            q = np.clip(np.round(centers / scale), -INT8_MAX - 1, INT8_MAX)
            err = (centers - q * scale) ** 2
            mse = float((err * self._hist).sum() / total)
            if mse < best_mse:
                best_mse, best_amax = mse, amax
        return max(best_amax, EPS)


class EntropyCalibrator(_HistogramCalibrator):
    """TensorRT-style KL-divergence calibration: pick the clip bin ``i``
    minimizing KL(P || Q), P the clipped histogram (outliers folded into the
    last bin), Q P re-quantized into 128 levels and re-expanded."""

    name = "entropy"

    def __init__(self, num_bins: int = 2048, num_quant_levels: int = 128,
                 stride: int = 16):
        super().__init__(num_bins)
        self.num_quant_levels = int(num_quant_levels)
        self.stride = int(stride)
        # at exactly num_quant_levels bins the requantization is the
        # identity (KL == 0 degenerately), so the search starts at twice that
        self.start = 2 * self.num_quant_levels

    @staticmethod
    def _kl(p: np.ndarray, q: np.ndarray) -> float:
        mask = p > 0
        q = np.where(q > 0, q, 1e-12)
        return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))

    def compute_amax(self) -> float:
        total = self._hist.sum()
        if total == 0:
            return EPS
        hist = self._hist
        nq = self.num_quant_levels
        best_i, best_kl = self.num_bins, np.inf
        for i in range(self.start, self.num_bins + 1, self.stride):
            p = hist[:i].copy()
            p[-1] += hist[i:].sum()
            psum = p.sum()
            if psum == 0:
                continue
            p_n = p / psum
            chunks = np.array_split(p, nq)
            q = np.zeros_like(p)
            start = 0
            for c in chunks:
                nz = (c > 0).sum()
                if nz > 0:
                    q[start:start + len(c)][c > 0] = c.sum() / nz
                start += len(c)
            qsum = q.sum()
            if qsum == 0:
                continue
            kl = self._kl(p_n, q / qsum)
            if kl < best_kl:
                best_kl, best_i = kl, i
        return float(self._bin_edges()[min(best_i, self.num_bins)])


CALIBRATORS = {
    "minmax": MinMaxCalibrator,
    "percentile": PercentileCalibrator,
    "mse": MSECalibrator,
    "entropy": EntropyCalibrator,
}


def make_calibrator(name: str, **kwargs) -> Calibrator:
    if name not in CALIBRATORS:
        raise KeyError(
            f"unknown calibrator {name!r}; have {sorted(CALIBRATORS)}")
    return CALIBRATORS[name](**kwargs)

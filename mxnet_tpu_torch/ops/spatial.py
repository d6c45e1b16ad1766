"""Spatial vision ops: GridGenerator, BilinearSampler, SpatialTransformer,
ROIPooling, ROIAlign, RROIAlign, Correlation, im2col.

Counterpart of ``mxnet_tpu/ops/spatial.py`` (reference:
src/operator/spatial_transformer.cc, bilinear_sampler.cc,
grid_generator.cc, roi_pooling.cc, contrib/roi_align.cc,
contrib/rroi_align.cc, correlation.cc, nn/im2col.h).  Torch compositions
with the reference's static sampling: a bilinear read is four gathers
weighted by the fractional offsets, reading 0 outside the image, and the
ROI ops gather every ROI's sample grid at once.  ``BilinearSampler`` is
``F.grid_sample`` (``align_corners=True``, zero padding), which maps the
grid with ``(g + 1) (W - 1) / 2`` and reads 0 outside as the reference
does.  Gradients are torch autograd's of these compositions, as the
reference's are JAX's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import alias, register

__all__ = ["bilinear_gather"]


def bilinear_gather(data: torch.Tensor, batch: torch.Tensor,
                    x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of images ``data[batch]`` at pixel coordinates
    (x, y): data (B, C, H, W), batch (R,) integer, x and y (R, ...) ->
    (R, C, ...); a corner outside the image reads 0."""
    H, W = data.shape[2], data.shape[3]
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    b = batch.long().reshape((-1,) + (1,) * (x.dim() - 1))

    def at(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        v = data[b, :, yc, xc]                       # (R, ..., C)
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    out = (at(x0, y0) * ((1 - dx) * (1 - dy))[..., None]
           + at(x0 + 1, y0) * (dx * (1 - dy))[..., None]
           + at(x0, y0 + 1) * ((1 - dx) * dy)[..., None]
           + at(x0 + 1, y0 + 1) * (dx * dy)[..., None])
    return out.movedim(-1, 1)


def _identity_grid(H, W, dtype, device):
    ys = torch.linspace(-1.0, 1.0, H, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, W, dtype=dtype, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """``affine``: data (B, 6) -> grid (B, 2, H, W) of normalised [-1, 1]
    (x, y) coordinates; ``warp``: data (B, 2, H, W), a flow in pixels,
    added to the identity grid."""
    if transform_type == "affine":
        H, W = target_shape
        gy, gx = _identity_grid(H, W, data.dtype, data.device)
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones(H * W, dtype=data.dtype,
                                       device=data.device)])     # (3, HW)
        theta = data.reshape(-1, 2, 3)
        return torch.einsum("bij,jk->bik", theta, base).reshape(-1, 2, H, W)
    Hd, Wd = data.shape[2], data.shape[3]
    gy, gx = _identity_grid(Hd, Wd, data.dtype, data.device)
    ident = torch.stack([gx, gy])[None]
    flow = torch.stack([data[:, 0] * 2.0 / max(Wd - 1, 1),
                        data[:, 1] * 2.0 / max(Hd - 1, 1)], dim=1)
    return ident + flow


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False):
    """data (B, C, H, W) sampled at grid (B, 2, Ho, Wo) of normalised
    (x, y) in [-1, 1] -> (B, C, Ho, Wo)."""
    return F.grid_sample(data, grid.permute(0, 2, 3, 1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=tuple(target_shape))
    return _bilinear_sampler(data, grid)


def _float_rois(rois):
    return rois if rois.is_floating_point() else rois.float()


def _bins(start, size, bins, offsets, device):
    """(R, bins * len(offsets)) sample coordinates: ``start + (bin +
    offset) * size / bins``."""
    steps = (torch.arange(bins, dtype=torch.float32, device=device)[:, None]
             + torch.tensor(offsets, dtype=torch.float32,
                            device=device)).reshape(-1)
    return start[:, None] + steps[None, :] * (size / bins)[:, None]


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """rois (R, 5) [batch, x1, y1, x2, y2] in image coordinates; each ROI
    max-pooled into ``pooled_size`` bins from 2 x 2 rounded samples a bin
    -> (R, C, PH, PW)."""
    PH, PW = pooled_size
    H, W = data.shape[2], data.shape[3]
    r = _float_rois(rois)
    x1, y1 = r[:, 1] * spatial_scale, r[:, 2] * spatial_scale
    x2, y2 = r[:, 3] * spatial_scale, r[:, 4] * spatial_scale
    rw = (x2 - x1 + 1.0).clamp_min(1.0)
    rh = (y2 - y1 + 1.0).clamp_min(1.0)
    sx = _bins(x1, rw, PW, (0.25, 0.75), data.device)      # (R, PW*2)
    sy = _bins(y1, rh, PH, (0.25, 0.75), data.device)      # (R, PH*2)
    xi = torch.round(sx).clamp(0, W - 1).long()[:, None, :]
    yi = torch.round(sy).clamp(0, H - 1).long()[:, :, None]
    b = r[:, 0].long()[:, None, None]
    vals = data[b, :, yi, xi]                 # (R, PH*2, PW*2, C)
    vals = vals.movedim(-1, 1).reshape(-1, data.shape[1], PH, 2, PW, 2)
    return vals.amax(dim=(3, 5))


@register("_contrib_ROIAlign")
def _roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
               sample_ratio=2, position_sensitive=False, aligned=False):
    """The mean of ``sample_ratio``^2 bilinear samples a bin (reference:
    contrib/roi_align.cc) -> (R, C, PH, PW)."""
    PH, PW = pooled_size
    S = max(int(sample_ratio), 1)
    off = 0.5 if aligned else 0.0
    r = _float_rois(rois)
    x1 = r[:, 1] * spatial_scale - off
    y1 = r[:, 2] * spatial_scale - off
    x2 = r[:, 3] * spatial_scale - off
    y2 = r[:, 4] * spatial_scale - off
    floor = 1e-6 if aligned else 1.0
    rw = (x2 - x1).clamp_min(floor)
    rh = (y2 - y1).clamp_min(floor)
    offsets = tuple((i + 0.5) / S for i in range(S))
    gx = _bins(x1, rw, PW, offsets, data.device)           # (R, PW*S)
    gy = _bins(y1, rh, PH, offsets, data.device)           # (R, PH*S)
    mx = gx[:, None, :].expand(-1, PH * S, -1)
    my = gy[:, :, None].expand(-1, -1, PW * S)
    vals = bilinear_gather(data, r[:, 0], mx, my)   # (R, C, PH*S, PW*S)
    vals = vals.reshape(vals.shape[0], vals.shape[1], PH, S, PW, S)
    return vals.mean(dim=(3, 5))


alias("_contrib_ROIAlign", "ROIAlign", "roi_align")


@register("_contrib_RROIAlign", aliases=["RROIAlign"])
def _rroi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
                sampling_ratio=2):
    """Rotated ROI align: rois (R, 6) [batch, cx, cy, w, h, angle in
    degrees]; each bin the mean of ``sampling_ratio``^2 bilinear samples
    of a grid rotated about (cx, cy) -> (R, C, PH, PW)."""
    PH, PW = pooled_size
    S = max(int(sampling_ratio), 1)
    r = _float_rois(rois)
    cx = r[:, 1] * spatial_scale
    cy = r[:, 2] * spatial_scale
    rw = (r[:, 3] * spatial_scale).clamp_min(1.0)
    rh = (r[:, 4] * spatial_scale).clamp_min(1.0)
    theta = r[:, 5] * math.pi / 180.0
    ix = (torch.arange(S, dtype=data.dtype, device=data.device) + 0.5) / S
    lx = ((torch.arange(PW, dtype=data.dtype, device=data.device)[:, None]
           + ix) / PW - 0.5).reshape(-1)[None, :] * rw[:, None]
    ly = ((torch.arange(PH, dtype=data.dtype, device=data.device)[:, None]
           + ix) / PH - 0.5).reshape(-1)[None, :] * rh[:, None]
    gx = lx[:, None, :].expand(-1, PH * S, -1)
    gy = ly[:, :, None].expand(-1, -1, PW * S)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    sx = cx[:, None, None] + gx * c - gy * s
    sy = cy[:, None, None] + gx * s + gy * c
    vals = bilinear_gather(data, r[:, 0], sx, sy)
    vals = vals.reshape(vals.shape[0], vals.shape[1], PH, S, PW, S)
    return vals.mean(dim=(3, 5))


@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation with a 1-pixel patch: for each displacement of
    the (2d + 1)^2 window (step ``stride2``), the channel mean of
    ``data1 * shifted data2`` (or of ``-|data1 - shifted data2|``)."""
    d = max_displacement
    H, W = data1.shape[2], data1.shape[3]
    p2 = F.pad(data2, (d, d, d, d))
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            b = p2[:, :, d + dy:d + dy + H, d + dx:d + dx + W]
            prod = data1 * b if is_multiply else -(data1 - b).abs()
            outs.append(prod.mean(dim=1))
    return torch.stack(outs, dim=1)


@register("im2col")
def _im2col(data, kernel=(1, 1), stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """(B, C, H, W) -> (B, C * kh * kw, L) patches, channel-major."""
    return F.unfold(data, tuple(kernel), dilation=tuple(dilate),
                    padding=tuple(pad), stride=tuple(stride))

"""Convolution and pooling layers as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (``_Conv``,
Conv1D-3D, Conv1D-3DTranspose, ``_Pooling``, Max/Avg/GlobalMax/GlobalAvg
Pool 1D-3D, ReflectionPad2D), with the gluon parameter names ``weight``
(OIHW; IOHW for the transposes) and ``bias``, each filled by its
``weight_initializer`` / ``bias_initializer`` under the reference's name
rule; ``in_channels`` of 0 (the default) is inferred from the first
input (``infer_shape``).  Layouts
are channel-first (NCW, NCHW, NCDHW), the reference's; the convolutions
and pools are cuDNN's through :mod:`...ops.nn`, reached as the registered
ops ``Convolution``, ``Deconvolution``, ``Pooling`` and ``pad`` through
``registry.dispatch`` (where the AMP policy casts their inputs).
"""
from __future__ import annotations

from ...ops.registry import dispatch
from ..block import HybridBlock
from ..parameter import meta_parameter, param_handle, set_inits

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]

_LAYOUTS = ("NCW", "NCHW", "NCDHW")


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """Shared convolution layer: ``channels`` filters of ``kernel_size``
    over ``in_channels`` inputs in ``groups`` groups, then ``activation``
    if one is named."""

    _op = "Convolution"

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if layout not in _LAYOUTS:
            raise ValueError("layout %r: only channel-first layouts %s"
                             % (layout, _LAYOUTS))
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tup(kernel_size, 1)
        ndim = len(self._kernel)
        self._stride = _tup(strides, ndim)
        self._pad = _tup(padding, ndim)
        self._dilate = _tup(dilation, ndim)
        self._groups = groups
        self._act = activation
        self.weight = meta_parameter(self._weight_shape(in_channels), dtype)
        self.bias = meta_parameter((channels,), dtype) if use_bias else None
        set_inits(self, weight=weight_initializer, bias=bias_initializer)

    def _weight_shape(self, in_channels):
        # OIHW: (num_filter, in_channels / groups, *kernel)
        return (self._channels, in_channels // self._groups) + self._kernel

    def infer_shape(self, x, *args):
        self._in_channels = x.shape[1]
        param_handle(self, "weight").shape = self._weight_shape(x.shape[1])

    def _op_args(self):
        return {}

    def forward(self, x):
        p = self._parameters
        out = dispatch(self._op, x, p["weight"], p.get("bias"),
                       kernel=self._kernel,
                       stride=self._stride, dilate=self._dilate,
                       pad=self._pad, num_filter=self._channels,
                       num_group=self._groups, no_bias=p.get("bias") is None,
                       **self._op_args())
        if self._act:
            out = dispatch("Activation", out, act_type=self._act)
        return out

    def extra_repr(self):
        return "%d -> %d, kernel_size=%s, stride=%s, padding=%s" % (
            self._in_channels, self._channels, self._kernel, self._stride,
            self._pad)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, **kwargs)


class _ConvTranspose(_Conv):
    """Transposed convolution; ``output_padding`` is the op's ``adj``."""

    _op = "Deconvolution"

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, **kwargs)
        self._out_pad = _tup(output_padding, len(self._kernel))

    def _weight_shape(self, in_channels):
        # (in_channels, channels / groups, *kernel)
        return (in_channels, self._channels // self._groups) + self._kernel

    def _op_args(self):
        return {"adj": self._out_pad}


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         output_padding, dilation, groups, layout, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         output_padding, dilation, groups, layout, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         output_padding, dilation, groups, layout, **kwargs)


class _Pooling(HybridBlock):
    """Shared pooling layer; ``ceil_mode`` is the op's ``full``
    convention (the reference's right padding, not torch's
    ``ceil_mode``)."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._ceil = ceil_mode
        self._global = global_pool
        self._type = pool_type
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return dispatch(
            "Pooling", x, kernel=self._kernel, pool_type=self._type,
            global_pool=self._global, stride=self._stride, pad=self._pad,
            pooling_convention="full" if self._ceil else "valid",
            count_include_pad=self._count_include_pad)

    def extra_repr(self):
        return "size=%s, stride=%s, padding=%s, ceil_mode=%s" % (
            self._kernel, self._stride, self._pad, self._ceil)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 1), None if strides is None else
                         _tup(strides, 1), _tup(padding, 1), ceil_mode,
                         **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), None if strides is None else
                         _tup(strides, 2), _tup(padding, 2), ceil_mode,
                         **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 3), None if strides is None else
                         _tup(strides, 3), _tup(padding, 3), ceil_mode,
                         **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 1), None if strides is None else
                         _tup(strides, 1), _tup(padding, 1), ceil_mode,
                         pool_type="avg", count_include_pad=count_include_pad,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 2), None if strides is None else
                         _tup(strides, 2), _tup(padding, 2), ceil_mode,
                         pool_type="avg", count_include_pad=count_include_pad,
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 3), None if strides is None else
                         _tup(strides, 3), _tup(padding, 3), ceil_mode,
                         pool_type="avg", count_include_pad=count_include_pad,
                         **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), global_pool=True, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), global_pool=True, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), global_pool=True,
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), global_pool=True, pool_type="avg",
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), global_pool=True,
                         pool_type="avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), global_pool=True,
                         pool_type="avg", **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of an NCHW input: ``padding`` on every side, or
    the reference's 8-tuple of (before, after) pairs for N, C, H, W, whose
    N and C pairs must be 0."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        padding = tuple(padding)
        if len(padding) != 8 or any(padding[:4]):
            raise ValueError("ReflectionPad2D pads H and W only, got %s"
                             % (padding,))
        self._padding = padding

    def forward(self, x):
        return dispatch("pad", x, mode="reflect", pad_width=self._padding)

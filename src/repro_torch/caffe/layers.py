"""The ported Caffe blocks, as functional executors over portable ops
(``repro.caffe.layers``).

Each layer implements Caffe's triple interface:

    init(generator, bottom_shapes, device) -> (params, top_shapes)
    forward(params, bottoms, train)        -> (tops, cache)
    backward(params, cache, top_diffs)     -> (bottom_diffs, param_diffs)

``forward`` is built from ``repro_torch.kernels.ops`` only, so the whole
net is single-source across backends (the paper's core claim): on the
card the hopper backend runs every layer through the Hopper kernels, and
the solver differentiates it with autograd through the ops' Functions.
``backward`` is Caffe's explicit backprop, line for line JAX's
(``repro/caffe/layers.py:88-248``): Convolution and InnerProduct through
``ops.im2col``, ``ops.matmul`` and ``ops.col2im`` (kernels on the hopper
backend), Pooling, ReLU and SoftmaxWithLoss through the plain oracles
(``ref.maxpool_bwd``, ``ref.relu_bwd``, ``ref.softmax_xent_bwd``) as
JAX's do.  It is the independent gradient oracle the tests hold autograd
to, and the backward the paper's partial-port modes time.

The fillers draw from an explicit ``torch.Generator`` on its own device,
in layer order, and the params then move to ``device``: xavier is
uniform in +-sqrt(3 / fan_in), gaussian has ``filler_std``; biases are
zero.  ``jax.random`` cannot be reproduced in torch, so the params differ
from JAX's for the same seed; tests hand JAX's across
(``repro_torch.convert.caffe_params_from_jax``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.caffe.spec import LayerSpec
from repro_torch.kernels import ops, ref

Params = Dict[str, torch.Tensor]

def _filler(gen: torch.Generator, shape, spec: LayerSpec, fan_in: int,
            device: torch.device) -> torch.Tensor:
    if spec.weight_filler == "xavier":
        scale = math.sqrt(3.0 / fan_in)
        w = torch.empty(shape, dtype=torch.float32, device=gen.device)
        w.uniform_(-scale, scale, generator=gen)
    else:
        w = spec.filler_std * torch.randn(shape, generator=gen,
                                          dtype=torch.float32,
                                          device=gen.device)
    return w.to(device)


class Layer:
    def __init__(self, spec: LayerSpec):
        self.spec = spec

    @property
    def name(self) -> str:
        return self.spec.name

    def init(self, gen: torch.Generator, bottom_shapes,
             device: torch.device):
        return {}, self.infer_shapes(bottom_shapes)

    def infer_shapes(self, bottom_shapes):
        raise NotImplementedError

    def forward(self, params: Params, bottoms, train: bool):
        raise NotImplementedError

    def backward(self, params: Params, cache, top_diffs):
        raise NotImplementedError


class Convolution(Layer):
    """im2col + GEMM convolution (the paper's §3.1)."""

    def infer_shapes(self, bottom_shapes):
        (n, c, h, w), = bottom_shapes
        s = self.spec
        oh = ref.conv_out_size(h, s.kernel_size, s.stride, s.pad)
        ow = ref.conv_out_size(w, s.kernel_size, s.stride, s.pad)
        return [(n, s.num_output, oh, ow)]

    def init(self, gen, bottom_shapes, device):
        (n, c, h, w), = bottom_shapes
        s = self.spec
        k = s.kernel_size
        params = {"w": _filler(gen, (s.num_output, c, k, k), s, c * k * k,
                               device)}
        if s.bias_term:
            params["b"] = torch.zeros((s.num_output,), dtype=torch.float32,
                                      device=device)
        return params, self.infer_shapes(bottom_shapes)

    def forward(self, params, bottoms, train: bool):
        (x,) = bottoms
        s = self.spec
        y = ops.conv2d(x, params["w"], params.get("b"), stride=s.stride,
                       pad=s.pad)
        return [y], {"x": x}

    def backward(self, params, cache, top_diffs):
        (dy,) = top_diffs
        s = self.spec
        x, w = cache["x"], params["w"]
        f, c, kh, kw = w.shape
        n = x.shape[0]
        oh, ow = dy.shape[2], dy.shape[3]
        cols = ops.im2col(x, kh, kw, s.stride, s.pad)
        dy_flat = dy.reshape(n, f, oh * ow).transpose(0, 1).reshape(f, -1)
        cols_flat = cols.transpose(0, 1).reshape(c * kh * kw, -1)
        dw = ops.matmul(dy_flat, cols_flat.T).reshape(w.shape)
        dcols = ops.matmul(w.reshape(f, -1).T, dy_flat)
        dcols = dcols.reshape(c * kh * kw, n, oh * ow).transpose(0, 1)
        dx = ops.col2im(dcols, tuple(x.shape), kh, kw, s.stride, s.pad)
        grads = {"w": dw}
        if s.bias_term:
            grads["b"] = dy.sum(dim=(0, 2, 3))
        return [dx], grads


class InnerProduct(Layer):
    """GEMM + matrixPlusVectorRows (the paper's Listing 1.2)."""

    def infer_shapes(self, bottom_shapes):
        return [(bottom_shapes[0][0], self.spec.num_output)]

    def init(self, gen, bottom_shapes, device):
        k = math.prod(bottom_shapes[0][1:])
        s = self.spec
        params = {"w": _filler(gen, (k, s.num_output), s, k, device)}
        if s.bias_term:
            params["b"] = torch.zeros((s.num_output,), dtype=torch.float32,
                                      device=device)
        return params, self.infer_shapes(bottom_shapes)

    def forward(self, params, bottoms, train: bool):
        (x,) = bottoms
        y = ops.matmul(x.reshape(x.shape[0], -1), params["w"])
        if self.spec.bias_term:
            y = ops.bias_add_rows(y, params["b"])
        return [y], {"x": x}

    def backward(self, params, cache, top_diffs):
        (dy,) = top_diffs
        x = cache["x"]
        x2 = x.reshape(x.shape[0], -1)
        dw = ops.matmul(x2.T, dy)
        dx = ops.matmul(dy, params["w"].T).reshape(x.shape)
        grads = {"w": dw}
        if self.spec.bias_term:
            grads["b"] = dy.sum(dim=0)
        return [dx], grads


class Pooling(Layer):
    def infer_shapes(self, bottom_shapes):
        (n, c, h, w), = bottom_shapes
        s = self.spec
        oh = ref.conv_out_size(h, s.kernel_size, s.stride, s.pad)
        ow = ref.conv_out_size(w, s.kernel_size, s.stride, s.pad)
        return [(n, c, oh, ow)]

    def forward(self, params, bottoms, train: bool):
        (x,) = bottoms
        s = self.spec
        if s.pool == "max":
            # one pool evaluation yields both the output and the argmax
            # (Caffe stores the mapping for the explicit backward)
            y, arg = ops.maxpool_with_argmax(x, s.kernel_size, s.stride,
                                             s.pad)
            return [y], {"arg": arg, "x_shape": tuple(x.shape)}
        y = ops.avgpool(x, s.kernel_size, s.stride, s.pad)
        return [y], {"x_shape": tuple(x.shape)}

    def backward(self, params, cache, top_diffs):
        (dy,) = top_diffs
        s = self.spec
        k, st, pad = s.kernel_size, s.stride, s.pad
        if s.pool == "max":
            return [ref.maxpool_bwd(dy, cache["arg"], cache["x_shape"], k,
                                    st, pad)], {}
        # average pool: each window's gradient spread evenly over its
        # k * k taps, then folded back
        n, c = cache["x_shape"][:2]
        dcols = (dy / (k * k)).reshape(n, c, 1, -1).expand(
            n, c, k * k, dy.shape[2] * dy.shape[3]).reshape(n, c * k * k, -1)
        return [ref.col2im(dcols, cache["x_shape"], k, k, st, pad)], {}


class ReLU(Layer):
    """Caffe implements the leaky variant (paper §3, block list)."""

    def infer_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train: bool):
        (x,) = bottoms
        return [ops.relu(x, self.spec.negative_slope)], {"x": x}

    def backward(self, params, cache, top_diffs):
        (dy,) = top_diffs
        return [ref.relu_bwd(cache["x"], dy, self.spec.negative_slope)], {}


class Softmax(Layer):
    def infer_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms, train: bool):
        (x,) = bottoms
        p = ops.softmax(x)
        return [p], {"p": p}

    def backward(self, params, cache, top_diffs):
        (dy,) = top_diffs
        p = cache["p"]
        return [p * (dy - (dy * p).sum(dim=-1, keepdim=True))], {}


class SoftmaxWithLoss(Layer):
    def infer_shapes(self, bottom_shapes):
        return [()]

    def forward(self, params, bottoms, train: bool):
        logits, labels = bottoms
        loss = ops.softmax_xent_loss(logits, labels) * self.spec.loss_weight
        # the cache keeps the plain softmax, as JAX's layer does
        # (``repro/caffe/layers.py:224``)
        probs = ref.softmax(logits)
        return [loss], {"probs": probs, "labels": labels}

    def backward(self, params, cache, top_diffs):
        (dloss,) = top_diffs  # scalar
        dlogits = (ref.softmax_xent_bwd(cache["probs"], cache["labels"])
                   * self.spec.loss_weight * dloss)
        return [dlogits, None], {}


class Accuracy(Layer):
    """Not a real layer (paper: 'implicitly included'); metric only."""

    def infer_shapes(self, bottom_shapes):
        return [()]

    def forward(self, params, bottoms, train: bool):
        logits, labels = bottoms
        return [ops.accuracy(logits, labels, self.spec.top_k)], {}

    def backward(self, params, cache, top_diffs):
        return [None, None], {}


LAYER_TYPES = {
    "Convolution": Convolution,
    "InnerProduct": InnerProduct,
    "Pooling": Pooling,
    "ReLU": ReLU,
    "Softmax": Softmax,
    "SoftmaxWithLoss": SoftmaxWithLoss,
    "Accuracy": Accuracy,
}


def build_layer(spec: LayerSpec) -> Layer:
    try:
        return LAYER_TYPES[spec.type](spec)
    except KeyError as e:
        raise KeyError(
            f"unknown layer type {spec.type!r}; known: {sorted(LAYER_TYPES)}"
        ) from e

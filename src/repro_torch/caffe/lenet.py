"""The paper's two evaluation networks, as NetSpecs (``repro.caffe.lenet``).

1. LeNet for MNIST — Caffe's ``lenet_train_test.prototxt``: 6 layers
   (2 Convolution, 2 Pooling, 2 InnerProduct) + ReLU + SoftmaxWithLoss +
   Accuracy.
2. CIFAR-10 quick — Caffe's ``cifar10_quick_train_test.prototxt``: 8 layers
   (3 Convolution, 3 Pooling, 2 InnerProduct) + ReLUs + SoftmaxWithLoss +
   Accuracy, with overlapping 3/2 pools (max + 2 average).
"""
from __future__ import annotations

from repro_torch.caffe.spec import LayerSpec, NetSpec, SolverSpec


def L(name, type, bottoms, tops, **kw):
    return LayerSpec(
        name=name, type=type, bottoms=tuple(bottoms), tops=tuple(tops), **kw
    )


def lenet_mnist() -> NetSpec:
    return NetSpec(
        name="lenet-mnist",
        input_shape=(1, 28, 28),
        num_classes=10,
        layers=(
            L("conv1", "Convolution", ["data"], ["conv1"],
              num_output=20, kernel_size=5, stride=1),
            L("pool1", "Pooling", ["conv1"], ["pool1"],
              kernel_size=2, stride=2, pool="max"),
            L("conv2", "Convolution", ["pool1"], ["conv2"],
              num_output=50, kernel_size=5, stride=1),
            L("pool2", "Pooling", ["conv2"], ["pool2"],
              kernel_size=2, stride=2, pool="max"),
            L("ip1", "InnerProduct", ["pool2"], ["ip1"], num_output=500),
            L("relu1", "ReLU", ["ip1"], ["ip1r"]),
            L("ip2", "InnerProduct", ["ip1r"], ["ip2"], num_output=10),
            L("loss", "SoftmaxWithLoss", ["ip2", "label"], ["loss"]),
            L("accuracy", "Accuracy", ["ip2", "label"], ["accuracy"]),
        ),
    )


def lenet_cifar10() -> NetSpec:
    return NetSpec(
        name="lenet-cifar10",
        input_shape=(3, 32, 32),
        num_classes=10,
        layers=(
            L("conv1", "Convolution", ["data"], ["conv1"],
              num_output=32, kernel_size=5, pad=2, weight_filler="gaussian",
              filler_std=1e-4),
            L("pool1", "Pooling", ["conv1"], ["pool1"],
              kernel_size=3, stride=2, pool="max"),
            L("relu1", "ReLU", ["pool1"], ["pool1r"]),
            L("conv2", "Convolution", ["pool1r"], ["conv2"],
              num_output=32, kernel_size=5, pad=2, weight_filler="gaussian",
              filler_std=0.01),
            L("relu2", "ReLU", ["conv2"], ["conv2r"]),
            L("pool2", "Pooling", ["conv2r"], ["pool2"],
              kernel_size=3, stride=2, pool="ave"),
            L("conv3", "Convolution", ["pool2"], ["conv3"],
              num_output=64, kernel_size=5, pad=2, weight_filler="gaussian",
              filler_std=0.01),
            L("relu3", "ReLU", ["conv3"], ["conv3r"]),
            L("pool3", "Pooling", ["conv3r"], ["pool3"],
              kernel_size=3, stride=2, pool="ave"),
            L("ip1", "InnerProduct", ["pool3"], ["ip1"], num_output=64,
              weight_filler="gaussian", filler_std=0.1),
            L("ip2", "InnerProduct", ["ip1"], ["ip2"], num_output=10,
              weight_filler="gaussian", filler_std=0.1),
            L("loss", "SoftmaxWithLoss", ["ip2", "label"], ["loss"]),
            L("accuracy", "Accuracy", ["ip2", "label"], ["accuracy"]),
        ),
    )


def lenet_mnist_solver(**overrides) -> SolverSpec:
    cfg = dict(
        base_lr=0.01, momentum=0.9, weight_decay=5e-4,
        lr_policy="inv", gamma=1e-4, power=0.75,
        max_iter=500, batch_size=64,
    )
    cfg.update(overrides)
    return SolverSpec(**cfg)


def lenet_cifar10_solver(**overrides) -> SolverSpec:
    cfg = dict(
        base_lr=0.001, momentum=0.9, weight_decay=4e-3,
        lr_policy="fixed", max_iter=500, batch_size=64,
    )
    cfg.update(overrides)
    return SolverSpec(**cfg)

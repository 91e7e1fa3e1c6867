"""The paper's case study: the Caffe subset over the port's ops."""
from repro_torch.caffe.lenet import (  # noqa: F401
    lenet_cifar10,
    lenet_cifar10_solver,
    lenet_mnist,
    lenet_mnist_solver,
)
from repro_torch.caffe.net import Net  # noqa: F401
from repro_torch.caffe.solver import Solver  # noqa: F401
from repro_torch.caffe.spec import LayerSpec, NetSpec, SolverSpec  # noqa: F401

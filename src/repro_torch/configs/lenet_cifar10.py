"""The paper's CIFAR-10 quick network (Caffe cifar10_quick prototxt)."""
from repro_torch.caffe.lenet import lenet_cifar10, lenet_cifar10_solver

NET = lenet_cifar10()
SOLVER = lenet_cifar10_solver()

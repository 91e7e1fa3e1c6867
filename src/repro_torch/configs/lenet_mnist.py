"""The paper's own LeNet-MNIST network (Caffe lenet_train_test.prototxt)."""
from repro_torch.caffe.lenet import lenet_mnist, lenet_mnist_solver

NET = lenet_mnist()
SOLVER = lenet_mnist_solver()

"""The paper's own MNIST/FMNIST model: DNN 784x512x256x10, LeakyReLU(0.1),
SGD(0.1, mom 0.9), dropout 0.5 (Appendix B)."""

PAPER_DNN = dict(sizes=(784, 512, 256, 10), lr=0.1, momentum=0.9, dropout=0.5)
CONFIG = PAPER_DNN

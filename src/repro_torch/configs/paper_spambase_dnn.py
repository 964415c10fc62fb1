"""The paper's Spambase model: DNN 54x100x50x1, LeakyReLU(0.1),
SGD(0.05, mom 0.9), dropout 0.5 (Appendix B)."""

PAPER_DNN = dict(sizes=(54, 100, 50, 1), lr=0.05, momentum=0.9, dropout=0.5)
CONFIG = PAPER_DNN

"""An F-Net BasicBlock in one launch: two 3x3 convs C -> C with folded
BatchNorm, ReLU between them and the residual."""

from perfbench.counts import nbytes, products


def work(x, w1, s1, t1, w2, s2, t2, dil):
    N, H, W, C = x.shape
    return {"bytes": nbytes(x, w1, s1, t1, w2, s2, t2) + nbytes(x),
            **products(x, 2.0 * 2 * N * H * W * C * 9 * C)}

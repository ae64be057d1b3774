"""ResNet for CIFAR (port of ``hetu_tpu/models/resnet.py``; reference
examples/cnn): ResNet-18/34 of BasicBlocks, a 3x3 stem without pooling,
global average pooling and a Linear head.  Parameter names and shapes are
the JAX package's (HWIO conv weights, BatchNorm running stats as
non-trainable Variables), so ``Executor.load_params`` carries a JAX
executor's params, running stats included."""

from __future__ import annotations

from ..graph.node import scoped_init
from ..layers import Conv2d, BatchNorm, Linear
from ..ops import relu_op, global_avg_pool2d_op


class BasicBlock:
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, name="block",
                 channels_last=False):
        cl = channels_last
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            bias=False, channels_last=cl,
                            name=f"{name}_conv1")
        self.bn1 = BatchNorm(planes, channels_last=cl, name=f"{name}_bn1")
        self.conv2 = Conv2d(planes, planes, 3, stride=1, padding=1,
                            bias=False, channels_last=cl,
                            name=f"{name}_conv2")
        self.bn2 = BatchNorm(planes, channels_last=cl, name=f"{name}_bn2")
        self.shortcut = None
        if stride != 1 or in_planes != planes * self.expansion:
            self.sc_conv = Conv2d(in_planes, planes * self.expansion, 1,
                                  stride=stride, bias=False,
                                  channels_last=cl,
                                  name=f"{name}_scconv")
            self.sc_bn = BatchNorm(planes * self.expansion,
                                   channels_last=cl, name=f"{name}_scbn")
            self.shortcut = lambda x: self.sc_bn(self.sc_conv(x))

    def __call__(self, x):
        out = relu_op(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = self.shortcut(x) if self.shortcut else x
        return relu_op(out + sc)


class ResNet:
    """``channels_last``: inputs are [B, H, W, C] and every activation
    stays NHWC; by default NCHW, the reference's input contract.
    ``pipeline_stages`` arrives with slice F and raises here."""

    @scoped_init
    def __init__(self, num_blocks=(2, 2, 2, 2), num_classes=10,
                 name="resnet", pipeline_stages=None, channels_last=False):
        if pipeline_stages:
            raise NotImplementedError(
                "pipeline_stages arrives with slice F (pipeline "
                "parallelism) of the port (ROADMAP.md)")
        self.channels_last = channels_last
        self.in_planes = 64
        self.conv1 = Conv2d(3, 64, 3, stride=1, padding=1, bias=False,
                            channels_last=channels_last,
                            name=f"{name}_conv1")
        self.bn1 = BatchNorm(64, channels_last=channels_last,
                             name=f"{name}_bn1")
        self.layers = []
        for i, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), num_blocks, (1, 2, 2, 2))):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(self.in_planes, planes,
                                         stride if j == 0 else 1,
                                         channels_last=channels_last,
                                         name=f"{name}_l{i}b{j}"))
                self.in_planes = planes * BasicBlock.expansion
            self.layers.append(blocks)
        self.fc = Linear(512, num_classes, name=f"{name}_fc")

    def __call__(self, x):
        out = relu_op(self.bn1(self.conv1(x)))
        for blocks in self.layers:
            for b in blocks:
                out = b(out)
        out = global_avg_pool2d_op(out, channels_last=self.channels_last)
        return self.fc(out)


def resnet18(num_classes=10, channels_last=False):
    return ResNet((2, 2, 2, 2), num_classes, channels_last=channels_last)


def resnet34(num_classes=10, channels_last=False):
    return ResNet((3, 4, 6, 3), num_classes, channels_last=channels_last)

"""MobileNetV1/V2 (counterpart of paddle_tpu/vision/models/mobilenet.py,
the reference's mobilenetv1.py and mobilenetv2.py)."""
import torch

from ... import nn
from ...nn import functional as F


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1, act="relu"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "relu":
            x = F.relu(x)
        elif self.act == "relu6":
            x = F.relu6(x)
        return x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c1, out_c2, num_groups, stride, scale):
        super().__init__()
        self.dw = ConvBNLayer(in_c, int(out_c1 * scale), 3, stride=stride, padding=1,
                              groups=int(num_groups * scale))
        self.pw = ConvBNLayer(int(out_c1 * scale), int(out_c2 * scale), 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1)
        cfg = [(32, 32, 64, 32, 1), (64, 64, 128, 64, 2), (128, 128, 128, 128, 1),
               (128, 128, 256, 128, 2), (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
               (512, 512, 512, 512, 1), (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
               (1024, 1024, 1024, 1024, 1)]
        self.blocks = nn.Sequential(*[DepthwiseSeparable(int(in_c * scale), c1, c2, g, s,
                                                         scale)
                                      for in_c, c1, c2, g, s in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act="relu6"))
        layers += [ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride, padding=1,
                               groups=hidden_dim, act="relu6"),
                   ConvBNLayer(hidden_dim, oup, 1, act=None)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = int(32 * scale)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2), (6, 320, 1, 1)]
        self.conv1 = ConvBNLayer(3, input_channel, 3, stride=2, padding=1, act="relu6")
        blocks = []
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(input_channel, out_c, s if i == 0 else 1, t))
                input_channel = out_c
        self.blocks = nn.Sequential(*blocks)
        self.last_channel = int(1280 * max(1.0, scale))
        self.conv_last = ConvBNLayer(input_channel, self.last_channel, 1, act="relu6")
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.conv_last(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)

"""
The behaviour-cloning CNN policy (counterpart of
``torchdrivesim_tpu/models/policy.py:BirdviewCNNPolicy``).

Parameters are float32; the convolutions and the hidden dense layer compute
in ``dtype`` (bfloat16 by default) as the reference's flax module does with
its ``dtype``, and the output layer computes in float32. Inputs are
(B, C, H, W) images in [0, 255], as the renderer produces them.
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(size: int, kernel: int, stride: int):
    """(before, after) padding of one spatial dim under flax's 'SAME' rule:
    for a 3 x 3 kernel at stride 2 on an even size, 0 before and 1 after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class BirdviewCNNPolicy(nn.Module):
    """
    Strided 3 x 3 convolutions with ReLU, a spatial mean, a 128-wide hidden
    layer with ReLU and a ``tanh`` output of ``action_size`` actions in
    [-1, 1].

    Args:
        action_size: outputs.
        features: channels of each stride-2 convolution.
        dtype: compute type of the convolutions and the hidden layer.
        in_channels: image channels.
    """
    def __init__(self, action_size: int = 2, features: Sequence[int] = (32, 64, 128),
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        chans = [in_channels, *features]
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, stride=2, padding=0)
                                   for cin, cout in zip(chans[:-1], chans[1:]))
        self.dense_0 = nn.Linear(chans[-1], 128)
        self.dense_1 = nn.Linear(128, action_size)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = (image / 255.0).to(self.dtype)
        for conv in self.convs:
            pad_h = _same_pad(x.shape[-2], 3, 2)
            pad_w = _same_pad(x.shape[-1], 3, 2)
            x = F.pad(x, (*pad_w, *pad_h))
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype),
                                conv.bias.to(self.dtype), stride=2))
        # the mean accumulates in float32 and rounds to the compute type
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        x = F.relu(F.linear(x, self.dense_0.weight.to(self.dtype),
                            self.dense_0.bias.to(self.dtype)))
        x = F.linear(x.float(), self.dense_1.weight, self.dense_1.bias)
        return torch.tanh(x)

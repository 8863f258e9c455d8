"""The recipes' seeded weights: ``flax_init_`` draws a model's parameters as flax's default initialisers draw a JAX
recipe's tree, so that every recipe of the port starts from the distributions its JAX recipe starts from."""

import torch
from torch import nn

LECUN_STD = 0.87962566103423978  # the standard deviation of a unit normal truncated to [-2, 2]


def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw ``model``'s parameters from ``generator`` as flax's default initialisers draw a JAX recipe's tree:
    each kernel from lecun-normal (variance 1 / fan_in, a normal truncated at two of its deviations; a transposed
    convolution's fan-in is its input channels times its kernel, as flax's (K, in, out) kernel counts it), each
    recurrent matrix of an ``nn.RNN`` orthogonal, each embedding from N(0, 1 / E), every bias zero, every norm
    scale one, every ``PReLU`` slope 0.25.  The numbers are drawn on the generator's own device."""
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, leaf = modules[name.rpartition(".")[0]], name.rpartition(".")[2]
            if name.endswith("embedding.weight"):
                draw = torch.empty(p.shape, device=generator.device).normal_(0.0, p.shape[1] ** -0.5,
                                                                             generator=generator)
            elif isinstance(owner, nn.PReLU):
                draw = torch.full(p.shape, 0.25)
            elif leaf.startswith("weight_hh"):
                draw = nn.init.orthogonal_(torch.empty(p.shape, device=generator.device), generator=generator)
            elif p.dim() >= 2:
                fan_in = p.shape[0] * p[0, 0].numel() if getattr(owner, "transposed", False) else p[0].numel()
                std = fan_in ** -0.5 / LECUN_STD
                draw = nn.init.trunc_normal_(torch.empty(p.shape, device=generator.device), 0.0, std, -2 * std,
                                             2 * std, generator=generator)
            elif leaf.endswith("bias") or leaf.startswith("bias"):  # "in_proj_bias", "bias_ih_l0"
                draw = torch.zeros(p.shape)
            else:
                draw = torch.ones(p.shape)
            p.copy_(draw)

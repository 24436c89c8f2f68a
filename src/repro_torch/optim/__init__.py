from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, lookahead,
                                          make_optimizer)

__all__ = ["OPTIMIZERS", "Optimizer", "lookahead", "make_optimizer"]

"""paper-mlp — the paper's own model: MLP(512, 256, 128) + ReLU on 784-dim
inputs, 10 classes, trained with SGD(lr=1e-3, momentum=0.5) under DecAvg
over 100-node ER/BA/SBM graphs. [the reproduced paper, §5.1]
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperMLPConfig:
    arch_id: str = "paper-mlp"
    family: str = "mlp"
    source: str = "[reproduced paper §5.1]"
    in_dim: int = 784
    hidden: tuple = (512, 256, 128)
    num_classes: int = 10
    num_nodes: int = 100
    lr: float = 1e-3
    momentum: float = 0.5
    local_epochs: int = 1
    batch_size: int = 32


CONFIG = PaperMLPConfig()

"""The dry-run cases that ``dryrun_reference.py`` compiles with the JAX
reference and the port's tests trace on ``meta``: reduced archs x train,
prefill and decode at small input shapes x meshes (2, 2), (16, 16) and
(2, 16, 16), and the manual pipeline decoder. Plain Python, imported by
both sides."""

# kind -> (name, seq_len, global_batch, kind) of an ``InputShape``
SHAPES = {
    "train": ("train_small", 32, 64, "train"),
    "prefill": ("prefill_small", 16, 64, "prefill"),
    "decode": ("decode_small", 8, 64, "decode"),
}
MESHES = {"2x2": (2, 2), "16x16": (16, 16), "2x16x16": (2, 16, 16)}
ARCHS = ("llama3.2-1b", "dbrx-132b", "jamba-v0.1-52b", "rwkv6-3b", "whisper-base")
# (nodes, microbatches) of the train step; jamba's 16 reduced layers (two
# 8-layer periods of Mamba scans and MoE) train 2 nodes in one microbatch,
# which keeps its trace on ``meta`` and its compile in the reference short.
TRAIN = {"default": (4, 2), "jamba-v0.1-52b": (2, 1)}


def train_layout(arch):
    """(num_nodes, microbatches) of ``arch``'s train cases."""
    return TRAIN.get(arch, TRAIN["default"])
# The manual pipeline: reduced llama at 4 groups over 2 stages, TP 4 (one KV
# head a rank, where the port's layout is the reference's).
PIPE_CFG = {"num_layers": 4}
PIPE_MESHES = {"2x4": (2, 4), "2x2x4": (2, 2, 4)}


def axes_of(mesh_shape):
    return ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")


def cases():
    """(case id, arch, kind, mesh shape, pipeline)."""
    out = []
    for arch in ARCHS:
        for kind in SHAPES:
            for mname, mshape in MESHES.items():
                out.append((f"{arch}|{kind}|{mname}", arch, kind, mshape, False))
    for mname, mshape in PIPE_MESHES.items():
        out.append((f"llama3.2-1b|pipeline|{mname}", "llama3.2-1b", "decode", mshape, True))
    return out


def selected(case_id, selectors):
    """Whether ``case_id`` is picked by one of ``selectors`` (arch or
    arch:kind)."""
    arch, kind, _mesh = case_id.split("|")
    return bool({arch, f"{arch}:{kind}"} & set(selectors))

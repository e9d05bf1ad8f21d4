"""False-positive guard in PyTorch's idiom: patterns of the real package
that Layer 1 must pass clean. Never imported — analyzed only."""

import torch

TPULINT_CAPTURED = ("make_packed",)


def make_packed(model, depth: int):
    def predict(params, monitor, acc, temperature, cat_ids, numeric, mask):
        s, r = mask.shape  # metadata
        logits = torch.func.functional_call(model, params, (cat_ids, numeric))
        flags = torch.where(mask, logits > monitor.threshold, False).float()
        for _ in range(depth):  # a static Python loop: unrolled at capture
            logits = logits + 0.0
        if monitor is not None and cat_ids.dim() == 3:
            logits = logits.reshape(s, r)
        return torch.cat([torch.sigmoid(logits / temperature), flags]), acc

    return predict


def warm(engine, program, x):
    # Host code around a capture: syncs and reads belong here.
    out = program(x)
    torch.cuda.synchronize()
    return out.cpu().numpy(), float(out.sum())

"""Fig. 16: hardware-aware NN training at INT4 / INT8 / FP16 (port of
``repro/apps/train_mlp.py``).

LeNet-5-on-MNIST is substituted by the reference's LeNet-style conv net
on a deterministic synthetic digit dataset (procedural 12x12 glyph
templates + noise).  Convolution runs through the DPE via img2col (paper
Fig. 8c); the hardware layers train through ``mem_matmul``'s
straight-through backward.  Activations are NHWC, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps import cli_device
from repro_torch.core import DPEConfig, program_weight, spec
from repro_torch.core.layers import mem_linear, mem_matmul, mem_matmul_prepared
from repro_torch.core.prng import PRNGKey, fold_in, normal, split

IMG = 12
N_CLASSES = 8


def synth_digits(n_per_class: int, seed: int = 0, device="cuda"):
    """Procedural glyphs: each class is a fixed random low-freq template;
    samples add pixel noise + small shifts."""
    rng = np.random.default_rng(42)  # templates fixed across calls
    base = rng.standard_normal((N_CLASSES, 6, 6))
    templates = np.kron(base, np.ones((2, 2)))  # low-frequency 12x12
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(N_CLASSES):
        t = templates[c]
        for _ in range(n_per_class):
            dx, dy = rng.integers(-1, 2, 2)
            img = np.roll(np.roll(t, dx, 0), dy, 1)
            img = img + 0.35 * rng.standard_normal(img.shape)
            xs.append(img)
            ys.append(c)
    order = rng.permutation(len(xs))
    x = np.stack(xs)[order].astype(np.float32)
    y = np.array(ys)[order]
    return torch.from_numpy(x[..., None]).to(device), torch.from_numpy(y).to(device)


def img2col(x, k: int):
    """(B, H, W, C) -> (B, OH, OW, k*k*C) patches (paper Fig. 8c)."""
    b, h, w, c = x.shape
    oh, ow = h - k + 1, w - k + 1
    cols = torch.stack(
        [x[:, i:i + oh, j:j + ow, :] for i in range(k) for j in range(k)], dim=-2
    )  # (B, OH, OW, k*k, C)
    return cols.reshape(b, oh, ow, k * k * c), (oh, ow)


def max_pool(x, stride: int):
    """2x2 max pool of NHWC ``x`` with ``stride``, VALID padding (the
    reference's ``reduce_window``)."""
    _, h, w, _ = x.shape
    oh, ow = (h - 2) // stride + 1, (w - 2) // stride + 1
    win = [
        x[:, i:i + stride * (oh - 1) + 1:stride, j:j + stride * (ow - 1) + 1:stride, :]
        for i in range(2) for j in range(2)
    ]
    return torch.stack(win).amax(dim=0)


def conv_mem(x, w, cfg, key, k: int, prepared=None, kernels: bool = True):
    cols, (oh, ow) = img2col(x, k)
    b = x.shape[0]
    flat = cols.reshape(b * oh * ow, -1)
    if cfg is None:
        out = flat @ w
    elif prepared is not None:
        out = mem_matmul_prepared(flat, prepared, w.shape[1], cfg, kernels)
    else:
        out = mem_matmul(flat, w, key, cfg, kernels)
    return out.reshape(b, oh, ow, -1)


def init_net(key, device="cuda"):
    ks = split(key, 4)
    init = lambda k, shape: normal(k, shape, device) * (2.0 / shape[0]) ** 0.5  # noqa: E731
    return {
        "c1": init(ks[0], (9 * 1, 8)),    # 3x3 conv, 8 ch
        "c2": init(ks[1], (9 * 8, 16)),   # 3x3 conv, 16 ch
        "fc1": init(ks[2], (16 * 4, 32)),
        "fc2": init(ks[3], (32, N_CLASSES)),
    }


def program_net(params, cfg, key, kernels: bool = True):
    """Program the whole net once (the paper's ``load_state_dict`` +
    ``update_weight`` deployment flow).  Every layer shares ``key``,
    mirroring :func:`forward`'s per-call behaviour."""
    if cfg is None:
        return None
    return {k: program_weight(w, cfg, key, kernels=kernels) for k, w in params.items()}


def forward(params, x, cfg, key, programmed=None, kernels: bool = True):
    pg = programmed or {}
    relu = torch.relu
    h = relu(conv_mem(x, params["c1"], cfg, key, 3, pg.get("c1"), kernels))  # 10x10
    h = max_pool(h, 2)  # 5x5
    h = relu(conv_mem(h, params["c2"], cfg, key, 3, pg.get("c2"), kernels))  # 3x3
    h = max_pool(h, 1)  # 2x2
    h = h.reshape(h.shape[0], -1)
    h = relu(mem_linear(h, params["fc1"], None, cfg, key, prepared=pg.get("fc1"),
                        kernels=kernels))
    return mem_linear(h, params["fc2"], None, cfg, key, prepared=pg.get("fc2"),
                      kernels=kernels)


def nll(logits, y):
    """Mean negative log-likelihood of the labels ``y``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def sgd_momentum(params, grads, mom, lr: float):
    """The reference's update: ``m = 0.9 m + g``, ``p = p - lr m``."""
    mom = {k: 0.9 * mom[k] + grads[k] for k in params}
    params = {k: (params[k] - lr * mom[k]).detach().requires_grad_() for k in params}
    return params, mom


def train_step(params, mom, xb, yb, cfg, key, lr, kernels: bool = True):
    """One step: loss and straight-through gradients, then the update."""
    loss = nll(forward(params, xb, cfg, key, kernels=kernels), yb)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    with torch.no_grad():
        params, mom = sgd_momentum(params, grads, mom, lr)
    return params, mom, float(loss.detach())


def run(
    formats=("fp_full", "int4", "int8", "fp16"),
    steps: int = 120,
    batch: int = 64,
    var: float = 0.05,
    lr: float = 0.05,
    device: str = "cuda",
    kernels: bool = True,
):
    x_train, y_train = synth_digits(120, seed=0, device=device)
    x_test, y_test = synth_digits(30, seed=1, device=device)
    results = {}
    for name in formats:
        if name == "fp_full":
            cfg = None
        else:
            sp = spec(name)
            cfg = DPEConfig(
                input_spec=sp, weight_spec=sp, var=var, mode="fast",
                noise_mode="program" if var > 0 else "off",
            )
        params = {k: p.requires_grad_() for k, p in init_net(PRNGKey(0), device).items()}
        mom = {k: torch.zeros_like(p) for k, p in params.items()}
        losses = []
        for step in range(steps):
            i = (step * batch) % (x_train.shape[0] - batch)
            key = fold_in(PRNGKey(5), step)
            params, mom, loss = train_step(
                params, mom, x_train[i:i + batch], y_train[i:i + batch], cfg, key, lr,
                kernels,
            )
            losses.append(loss)
        with torch.no_grad():
            logits = forward(params, x_test, cfg, PRNGKey(123), kernels=kernels)
        acc = float((torch.argmax(logits, 1) == y_test).float().mean())
        results[name] = {
            "final_loss": losses[-1],
            "first_loss": losses[0],
            "test_acc": acc,
            "losses": losses,
        }
    return results


if __name__ == "__main__":
    for name, r in run(device=cli_device()).items():
        print(
            f"{name:8s} loss {r['first_loss']:.3f} -> {r['final_loss']:.3f} "
            f"test acc {r['test_acc']:.3f}"
        )

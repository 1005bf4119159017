"""Spike-to-spike validation (paper Sec. IV, Simulation & Validation Phase).

NumPy only: the same code as the JAX package's ``core/validate.py``, kept
here so the port imports nothing of that package.

The generated hardware is *functionally* validated by checking that its
output spike train equals the trained model's reference spikes at every time
step.  Two implementations of the same fixed-point datapath are compared:

* ``HardwareModel`` — faithful to the accelerator's dataflow: the ECU
  compresses each incoming train into an ascending address list (PENC
  order), each NU serially walks its assigned neurons per address and
  accumulates the int weight, then the activation phase applies the
  fixed-point LIF update (leak multiply is an integer multiply + arithmetic
  right shift, as in the RTL).
* ``reference_apply`` — the same arithmetic vectorised (integer matmul).

Because the datapath is integer, accumulation order cannot change results —
which is exactly why the hardware may process spikes in any order.  The
validation therefore demands **exact** equality, not allclose.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FRAC_BITS = 8


@dataclasses.dataclass
class FixedPointNet:
    """Quantized net: weights[l] int32 ((fan_in, n) dense / (kh, kw, cin, n)
    HWIO conv), biases[l]: (n,) int32.

    ``specs`` describes the layer sequence when the net is not a plain MLP:
    a list of ``("dense",)``, ``("conv", stride, padding)`` and
    ``("pool", window)`` tuples aligned with the model's layer list (dense
    and conv entries consume ``weights`` in order; pool entries carry no
    parameters).  ``None`` means all-dense — the original MLP contract.
    """
    weights: list[np.ndarray]
    biases: list[np.ndarray]
    beta_fp: int                 # round(beta * 2^frac)
    theta_fp: int                # round(threshold * 2^frac) in accumulator scale
    frac_bits: int = FRAC_BITS
    specs: list | None = None


def layer_specs(layers) -> list[tuple]:
    """Duck-typed ``FixedPointNet.specs`` from ``snn`` layer objects.

    Attribute-based so this module stays NumPy-pure (no model import):
    ``window`` ⇒ MaxPool, ``kernel`` ⇒ Conv, otherwise Dense.
    """
    specs: list[tuple] = []
    for layer in layers:
        if hasattr(layer, "window"):
            specs.append(("pool", int(layer.window)))
        elif hasattr(layer, "kernel"):
            specs.append(("conv", int(layer.stride), str(layer.padding)))
        else:
            specs.append(("dense",))
    return specs


def quantize(weights: list[np.ndarray], biases: list[np.ndarray],
             beta: float, threshold: float,
             frac_bits: int = FRAC_BITS,
             specs: list | None = None) -> FixedPointNet:
    # rounding contract (DESIGN.md §13): every weight/bias is round-to-
    # nearest on the 2^-frac_bits grid into int32; accumulation is exact
    # int64, so conv and dense layers share one arithmetic and results are
    # independent of spike/patch order.
    scale = 1 << frac_bits
    return FixedPointNet(
        weights=[np.round(np.asarray(w) * scale).astype(np.int32) for w in weights],
        biases=[np.round(np.asarray(b) * scale).astype(np.int32) for b in biases],
        beta_fp=int(round(beta * scale)),
        theta_fp=int(round(threshold * scale)),
        frac_bits=frac_bits,
        specs=specs,
    )


def _leak(u: np.ndarray, beta_fp: int, frac_bits: int) -> np.ndarray:
    # int multiply + arithmetic right shift == the RTL's leak datapath
    return (u.astype(np.int64) * beta_fp) >> frac_bits


def _is_mlp(net: FixedPointNet) -> bool:
    return net.specs is None or all(s[0] == "dense" for s in net.specs)


def _conv_out_size(size: int, kernel: int, stride: int,
                   padding: str) -> tuple[int, int, int]:
    """(out, pad_lo, pad_hi) for one spatial dim — XLA's SAME/VALID
    convention (numpy-pure twin of ``kernels.spike_conv.conv_out_size``)."""
    if padding == "SAME":
        out = -(-size // stride)
        pad = max((out - 1) * stride + kernel - size, 0)
        return out, pad // 2, pad - pad // 2
    if padding == "VALID":
        return (size - kernel) // stride + 1, 0, 0
    raise ValueError(f"unknown padding {padding!r}")


def _conv_int(x: np.ndarray, w: np.ndarray, stride: int,
              padding: str) -> np.ndarray:
    """Exact integer NHWC x HWIO convolution: (B,H,W,C) {0,1} spikes against
    int32 weights, accumulated in int64 (order-independent, like the dense
    datapath's integer matmul)."""
    B, H, W, _ = x.shape
    kh, kw, _, cout = w.shape
    oh, ph_lo, ph_hi = _conv_out_size(H, kh, stride, padding)
    ow, pw_lo, pw_hi = _conv_out_size(W, kw, stride, padding)
    xp = np.pad(x, ((0, 0), (ph_lo, ph_hi), (pw_lo, pw_hi), (0, 0)))
    acc = np.zeros((B, oh, ow, cout), np.int64)
    w64 = w.astype(np.int64)
    for dy in range(kh):
        for dx in range(kw):
            sl = xp[:, dy:dy + (oh - 1) * stride + 1:stride,
                    dx:dx + (ow - 1) * stride + 1:stride, :]
            acc += sl @ w64[dy, dx]
    return acc


def _or_pool_int(x: np.ndarray, window: int) -> np.ndarray:
    """Spike OR-pooling on a {0,1} (B,H,W,C) tensor, non-overlapping windows,
    VALID truncation of ragged edges (matches ``snn._or_pool``)."""
    B, H, W, C = x.shape
    oh, ow = H // window, W // window
    x = x[:, :oh * window, :ow * window, :]
    return x.reshape(B, oh, window, ow, window, C).max(axis=(2, 4))


def penc_compress(spike_bits: np.ndarray, chunk: int = 100) -> list[int]:
    """Chunked priority-encoder compression: ascending addresses within each
    chunk, chunks scanned in order — the ECU's shift-register content."""
    addrs = []
    n = len(spike_bits)
    for start in range(0, n, chunk):
        for off in np.nonzero(spike_bits[start:start + chunk])[0]:
            addrs.append(start + int(off))
    return addrs


class HardwareModel:
    """Serial functional model of the accelerator datapath (single sample)."""

    def __init__(self, net: FixedPointNet, lhr: list[int] | None = None):
        if not _is_mlp(net):
            raise ValueError("HardwareModel models the fc datapath only; "
                             "use reference_apply_batch for conv nets")
        self.net = net
        self.lhr = lhr or [1] * len(net.weights)

    def run(self, spike_input: np.ndarray) -> np.ndarray:
        """spike_input: (T, fan_in) {0,1}.  Returns (T, n_out) spikes."""
        net = self.net
        T = spike_input.shape[0]
        u = [np.zeros(w.shape[1], np.int64) for w in net.weights]
        s = [np.zeros(w.shape[1], np.int64) for w in net.weights]
        out = np.zeros((T, net.weights[-1].shape[1]), np.int64)
        for t in range(T):
            x = spike_input[t].astype(np.int64)
            for l, (w, b) in enumerate(zip(net.weights, net.biases)):
                addrs = penc_compress(x)
                n_neurons = w.shape[1]
                acc = np.zeros(n_neurons, np.int64)
                # NUs partitioned by base address; each walks its neurons
                # serially per spike address (paper Sec. V-C)
                lhr = self.lhr[l]
                for base in range(0, n_neurons, lhr):
                    hi = min(base + lhr, n_neurons)
                    for a in addrs:
                        for n_i in range(base, hi):
                            acc[n_i] += w[a, n_i]
                # activation phase: leak + accumulate + bias, threshold, reset
                u[l] = (_leak(u[l], net.beta_fp, net.frac_bits)
                        + acc + b - net.theta_fp * s[l])
                s[l] = (u[l] >= net.theta_fp).astype(np.int64)
                x = s[l]
            out[t] = s[-1]
        return out


def reference_apply(net: FixedPointNet, spike_input: np.ndarray) -> np.ndarray:
    """Vectorised fixed-point reference (integer matmul), same arithmetic.

    Single-sample, fc-only (the HardwareModel's comparison twin); conv nets
    go through ``reference_apply_batch``.
    """
    if not _is_mlp(net):
        raise ValueError("reference_apply is fc-only; use "
                         "reference_apply_batch for conv nets")
    T = spike_input.shape[0]
    u = [np.zeros(w.shape[1], np.int64) for w in net.weights]
    s = [np.zeros(w.shape[1], np.int64) for w in net.weights]
    out = np.zeros((T, net.weights[-1].shape[1]), np.int64)
    for t in range(T):
        x = spike_input[t].astype(np.int64)
        for l, (w, b) in enumerate(zip(net.weights, net.biases)):
            acc = x @ w.astype(np.int64)
            u[l] = (_leak(u[l], net.beta_fp, net.frac_bits)
                    + acc + b - net.theta_fp * s[l])
            s[l] = (u[l] >= net.theta_fp).astype(np.int64)
            x = s[l]
        out[t] = s[-1]
    return out


def validate(net: FixedPointNet, spike_input: np.ndarray,
             lhr: list[int] | None = None) -> bool:
    """Exact spike-to-spike equality between hardware model and reference."""
    hw = HardwareModel(net, lhr).run(spike_input)
    ref = reference_apply(net, spike_input)
    return bool(np.array_equal(hw, ref))


def population_predict(spike_out: np.ndarray, num_classes: int) -> np.ndarray:
    """(T, B, num_classes*pcr) output spikes -> (B,) predicted classes.

    Class-major population pooling, the layout the hardware generator
    assumes (neuron ``i`` belongs to class ``i // pcr``) — the NumPy twin of
    ``encoding.population_decode``.
    """
    totals = spike_out.sum(axis=0)                       # (B, n_out)
    b, n = totals.shape
    assert n % num_classes == 0, (n, num_classes)
    return totals.reshape(b, num_classes, n // num_classes).sum(-1).argmax(-1)


def quantized_accuracy(weights: list[np.ndarray], biases: list[np.ndarray],
                       spike_input: np.ndarray, labels: np.ndarray,
                       num_classes: int, *, frac_bits: int,
                       beta: float = 0.95, threshold: float = 1.0,
                       specs: list | None = None) -> float:
    """Classification accuracy of the fixed-point datapath at a given weight
    precision — the accuracy leg of the ``weight_bits`` DSE axis (the BRAM
    leg is ``dse.sweep_weight_bits`` / the ``bram`` objective).

    ``spike_input``: (T, B, fan_in) {0,1} for MLPs, (T, B, H, W, C) for conv
    nets (pass ``specs``, e.g. from ``layer_specs``); ``labels``: (B,).
    """
    net = quantize(weights, biases, beta, threshold, frac_bits=frac_bits,
                   specs=specs)
    pred = population_predict(reference_apply_batch(net, spike_input),
                              num_classes)
    return float((pred == np.asarray(labels)).mean())


def reference_apply_batch(net: FixedPointNet,
                          spike_input: np.ndarray) -> np.ndarray:
    """Vectorised fixed-point forward over a batch.

    spike_input: (T, B, fan_in) for MLPs, (T, B, H, W, C) for conv nets
    (per ``net.specs``) -> output spikes (T, B, n_out).  Used for
    quantization-accuracy studies (weight_bits DSE).  All layer kinds share
    the same integer LIF arithmetic; membrane/spike state is allocated
    lazily from each layer's first accumulate so spatial shapes flow
    through conv and pool stages.  Conv nets must end in a dense classifier
    (the topologies ``workloads.build`` emits always do).
    """
    specs = net.specs or [("dense",)] * len(net.weights)
    T, B = spike_input.shape[:2]
    n_lif = sum(1 for sp in specs if sp[0] != "pool")
    u: list = [None] * n_lif
    s: list = [None] * n_lif
    out = np.zeros((T, B, net.weights[-1].shape[1]), np.int64)
    for t in range(T):
        x = spike_input[t].astype(np.int64)
        li = 0
        for sp in specs:
            if sp[0] == "pool":
                x = _or_pool_int(x, sp[1])
                continue
            w, b = net.weights[li], net.biases[li]
            if sp[0] == "conv":
                acc = _conv_int(x, w, sp[1], sp[2])
                bias = b.astype(np.int64).reshape(1, 1, 1, -1)
            else:
                acc = x.reshape(B, -1) @ w.astype(np.int64)
                bias = b.astype(np.int64)[None]
            if u[li] is None:
                u[li] = np.zeros(acc.shape, np.int64)
                s[li] = np.zeros(acc.shape, np.int64)
            u[li] = (_leak(u[li], net.beta_fp, net.frac_bits)
                     + acc + bias - net.theta_fp * s[li])
            s[li] = (u[li] >= net.theta_fp).astype(np.int64)
            x = s[li]
            li += 1
        out[t] = x.reshape(B, -1)
    return out

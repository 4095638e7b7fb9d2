"""Device rule, counted host syncs and the port's tolerance table.

* `resolve_device`: entry points run on the card unless the caller names
  another device. With no device named and no CUDA device present they
  raise; nothing falls back to the CPU on its own.
* `to_host`: every device->host read of the port goes through this one
  helper, which counts it. It is the counterpart of the `np.asarray`
  syncs the JAX engine's tests count (tests/test_serving.py).
* `no_tf32`: full f32 products in a plain version on the card.
* `refuse_autograd`: the kernel wrappers' guard against a silent loss of
  gradients (a Hopper kernel has no backward).
* `TOLERANCES`: every comparison of the port against a plain version or
  against the JAX reference takes its tolerance from here, with its reason.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Raises when no CUDA device exists and none
    was asked for; an explicit device (e.g. "cpu") is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return torch.device("cuda")


class HostSyncCounter:
    """Counts device->host reads made through `to_host`."""

    def __init__(self):
        self.count = 0


HOST_SYNCS = HostSyncCounter()


def to_host(t: torch.Tensor) -> np.ndarray:
    """The port's one device->host read: returns a numpy copy of `t` and
    adds one to `HOST_SYNCS.count` (even for a CPU tensor, so the CPU tests
    count the same syncs the card would see)."""
    HOST_SYNCS.count += 1
    return t.detach().to("cpu").numpy()


@contextlib.contextmanager
def no_tf32():
    """Full f32 products on the card, never TF32, for this block only: the
    caller's setting is restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise where autograd would take a gradient through `kernel`'s
    wrapper: grad mode on and any input requiring grad. The Hopper kernel
    returns a tensor without a backward, so on the card the gradient of
    every input would be lost without a word; on the CPU the plain version
    would give one. The wrapper refuses on both devices alike."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the Hopper kernel has "
            f"no backward. The reference does not differentiate its Pallas "
            f"kernels either (jax.grad through pallas_call raises). Train "
            f"with Model(use_pallas=False, attention_impl='chunked', "
            f"ssd_impl='jnp'), or call the kernel under torch.no_grad()")


@dataclasses.dataclass(frozen=True)
class Tol:
    rtol: float
    atol: float
    why: str

    def _atol(self, ref: torch.Tensor):
        return self.atol

    def excess(self, got: torch.Tensor, ref: torch.Tensor) -> float:
        """max |got - ref| / (atol + rtol |ref|): at most 1 when `got` is
        within tolerance (NaN when either holds a NaN)."""
        got, ref = got.double(), ref.double()
        err = (got - ref).abs()
        ratio = err / (self._atol(ref) + self.rtol * ref.abs())
        return float(torch.where(err == 0, torch.zeros_like(err),
                                 ratio).max())

    def ok(self, got: torch.Tensor, ref: torch.Tensor) -> bool:
        return self.excess(got, ref) <= 1.0


@dataclasses.dataclass(frozen=True)
class RowTol(Tol):
    """atol is relative to the rms of each row of `ref` (its last axis).
    An attention output row is a weighted mean of the values its row sees,
    and shrinks as that row sees more keys (randn inputs: ~1 at row 0, ~0.04
    after 1000 keys), so a fixed atol is loose on the late rows."""

    def _atol(self, ref: torch.Tensor):
        return self.atol * ref.square().mean(dim=-1, keepdim=True).sqrt()


@dataclasses.dataclass(frozen=True)
class RmsTol(Tol):
    """atol is relative to the rms of the whole of `ref`: for a reference
    that rounds terms to bf16 before they cancel, so a row's own rms sets
    no floor under its error (the terms' scale is the output's)."""

    def _atol(self, ref: torch.Tensor):
        return self.atol * ref.square().mean().sqrt()


TOLERANCES: dict[str, Tol] = {
    # pod GEMM, kernel or port against its plain version / the JAX one
    "gemm_f32": Tol(1e-5, 1e-4,
                    "f32 accumulation in another order (tests/test_kernels.py)"),
    "gemm_bf16": Tol(2e-2, 2e-1,
                     "bf16 inputs: products are exact in f32, the order of "
                     "the sum differs and a bf16 result rounds once more "
                     "(tests/test_kernels.py; the CPU tests against JAX)"),
    # the Hopper kernel against its plain version on the card, with
    # fan-in-scaled weights (O(1) outputs); a kernel that sums in bf16
    # (an error of about 2**-9 per partial sum) misses both by 10x or more
    "gemm_bf16_f32out": Tol(1e-4, 1e-3,
                            "bf16 products are exact in f32; the tensor "
                            "cores round their f32 sums otherwise than "
                            "cuBLAS's FMA chain (seen: 3.4e-4 with the "
                            "epilogue, PERF.md)"),
    "gemm_bf16out": Tol(2 ** -6, 1e-4,
                        "both sides round f32 values that agree to ~1e-5 "
                        "to bf16: one ulp (at most 2**-7 relative) apart, "
                        "two allowed"),
    "gemm_int8_epilogue": Tol(1e-5, 1e-4,
                              "int32 accumulation is exact; the f32 epilogue "
                              "may fuse scale and bias into one FMA, and "
                              "exp/tanh differ in the last bits "
                              "(tests/test_kernels.py)"),
    "gemm_int8_exact": Tol(0.0, 0.0,
                           "int8 x int8 accumulates exactly in int32"),
    # layers and attention, port against the JAX functions (both on the CPU)
    "elementwise_f32": Tol(1e-5, 1e-5,
                           "f32 rsqrt/cos/sin differ in the last bits "
                           "between XLA and torch"),
    "elementwise_bf16": Tol(8e-3, 8e-3,
                            "one bf16 rounding (2**-7 relative) of f32 values "
                            "that differ in their last bits"),
    "sinusoid_f32": Tol(0.0, 2 ** -14,
                        "sin and cos of an f32 angle pos / 10000**(2i/d): "
                        "XLA's and torch's f32 pow differ in the last bit "
                        "of a few denominators, which moves an angle near "
                        "1000 rad (ulp 6e-5) by an ulp or two (seen: 3.05e-5 "
                        "at whisper's 1500 positions, d 768)"),
    "attention_f32": Tol(1e-5, 1e-5,
                         "f32 exp and sums in another order"),
    "attention_bf16": Tol(2e-2, 2e-2,
                          "bf16 scores and probabilities round at other "
                          "places: a few bf16 ulps"),
    "mixer_bf16": Tol(2e-2, 2e-2,
                      "a whole SSM mixer in bf16 (in_proj, conv, SSD, gated "
                      "norm, out_proj): XLA keeps fused bf16 intermediates "
                      "in f32 inside one jit where torch rounds each op, a "
                      "few bf16 ulps in all (seen: 1.1x elementwise_bf16)"),
    # flash attention, kernel against its plain version on the card and
    # plain version against the JAX Pallas kernel (interpret mode) on the
    # CPU; the gross planted controls of chip_smoke.py (a causal mask off
    # by one, a wrong GQA head map) miss both by 25x or more
    "flash_f32": Tol(2e-5, 2e-5,
                     "f32 exp and sums in another order: the kernel updates "
                     "its softmax key by key, the plain version normalises "
                     "once"),
    "flash_bf16": Tol(2e-2, 2e-2,
                      "the plain version rounds its scores to bf16 and "
                      "normalises p before the bf16 cast, the kernel keeps "
                      "f32 scores and casts p unnormalised: a few bf16 ulps "
                      "(tests/test_kernels.py holds Pallas to 2e-2)"),
    # the Hopper kernel (card) or the plain version of the Pallas kernel's
    # own arithmetic (CPU, against Pallas in interpret mode) against
    # flash_attention_tiled_ref with the same key tile: both round p at the
    # same running max, so they differ by the order of f32 sums only. The
    # late-tile controls of chip_smoke.py (a stale K tile, PV summed in
    # bf16) must fail it at granite-8b's [4, 2048, 32, 128]
    "flash_bf16_tiled": RowTol(2 ** -7, 2 ** -8,
                               "one bf16 ulp (at most 2**-7 relative) where "
                               "the output rounds the other way; atol 2**-8 "
                               "of the row's rms for f32 scores summed in "
                               "another order, which moves a few p across a "
                               "bf16 rounding"),
    "flash_bf16_tiled_large_scores": RowTol(
        2 ** -7, 2 ** -6,
        "as flash_bf16_tiled, for scores in the hundreds (layer 0 of "
        "random granite-8b weights): an f32 score there is exact to ~1e-4 "
        "only, so the sum order moves about half of the p across a bf16 "
        "rounding, each by 2**-8 relative; near-tied keys carry that into "
        "the output (readings in PERF.md)"),
    # the card's check of the kernel against flash_attention_tiled_ref,
    # over the ~10**7 outputs of a served prefill
    "flash_bf16_tiled_served": RowTol(
        2 ** -7, 2 ** -6,
        "as flash_bf16_tiled, over millions of rows: somewhere the sum "
        "order flips the p of a heavy key across a bf16 rounding, which "
        "moves an output by up to 2**-7 max|v| / l, past 2**-8 of the "
        "row's rms; the tiled plain version misses 2**-8 against itself "
        "with its scores summed in f64 (python "
        "tests/test_torch_flash_attention.py prints it) and stays at about "
        "half of 2**-6; the late-tile controls of chip_smoke.py miss 2**-6 "
        "by 1.8x or more"),
    # SSD chunk scan: the Hopper kernel (card) or the port's plain versions
    # (CPU, against the JAX reference and the Pallas kernel in interpret
    # mode). The planted controls of chip_smoke.py (no state carried
    # across chunks, the mask applied after exp, y_inter from the updated
    # state, ssd_ref, and the state and y_inter rounded to bf16) must fail
    # ssd_bf16_kernel at mamba2's [4, 2048, 32, 64]
    "ssd_f32": Tol(2e-4, 2e-4,
                   "f32 sums in another order and another exp "
                   "(tests/test_kernels.py holds Pallas to the reference at "
                   "2e-4)"),
    "ssd_f32_rows": RowTol(1e-4, 1e-4,
                           "f32 at mamba2-sized chunks (128 and up, dt ~ "
                           "softplus(randn)): a y row sums terms ~100x its "
                           "entries, so f32 sums in another order move an "
                           "entry near 0 by ~1e-5 of the row's scale, past "
                           "ssd_f32's 2e-4 absolute; atol is taken relative "
                           "to the row's rms instead. At mamba2's [4, 2048, "
                           "32, 64] on the card (chip_smoke.py) the plain "
                           "version at chunk 128 against itself at 256 reads "
                           "0.49 here, the kernel against the plain version "
                           "0.43 (1.46 under ssd_f32); no state carried, or "
                           "y_inter from the updated state, read 18,716 and "
                           "6.8e6"),
    "ssd_bf16_kernel": RowTol(2 ** -7, 2 ** -5,
                              "against ssd_kernel_ref, the Pallas kernel's "
                              "arithmetic: one bf16 ulp (at most 2**-7 "
                              "relative) where y rounds the other way, and "
                              "M entries that round to bf16 the other way "
                              "from f32 values summed in another order: a "
                              "flipped M_ts moves y_t by ulp(M_ts) |x_s|, "
                              "2**-5 of the row's rms at most. The same "
                              "plain version on the card and on the CPU "
                              "differs by as much; a bf16 state and y_inter "
                              "do not pass at mamba2's served shape "
                              "(readings in PERF.md)"),
    "ssd_bf16_reference": RmsTol(2 ** -5, 2 ** -4,
                                 "against ssd_ref (repro/models/ssm.py::"
                                 "ssd_reference), which keeps its state and "
                                 "inter-chunk output in bf16 where the "
                                 "kernels keep f32, and rounds M x to bf16 "
                                 "before D x cancels it: a few bf16 ulps of "
                                 "y, and 2**-4 of the output's rms (excess "
                                 "at most 0.46 for y, 0.28 for the state on "
                                 "mamba2-like inputs up to [2, 2048, 32, "
                                 "64]: `python tests/test_torch_ssd.py`)"),
    # model logits, port against the JAX Model (both on the CPU)
    "logits_bf16": Tol(0.1, 0.05,
                       "atol is relative to max|ref|: bf16 rounds at other "
                       "places in the two frameworks (tests/test_serving.py)"),
    "logits_f32": Tol(1e-5, 1e-5,
                      "atol is relative to max|ref|: f32 sums in another "
                      "order across two frameworks (seen: 2e-6 relative)"),
    # the encoder-decoder family (reduced whisper at the reference's init:
    # q, k and v drawn at fan-in over the head axis make attention outputs
    # ~8x their inputs, so the residual stream reaches ~50, std 13-19)
    "logits_f32_encdec": Tol(1e-5, 2e-5,
                             "atol is relative to max|ref|: f32 sums in "
                             "another order and XLA's tanh (GELU) move the "
                             "~50-sized residual by ~1.5e-6 of it a block "
                             "(seen: 1.21e-5 relative, encoder and logits)"),
    "logits_bf16_encdec": Tol(0.1, 0.3,
                              "atol is relative to max|ref|: one bf16 ulp "
                              "of the residual is 0.25 there, and the "
                              "encoder's carries into the cross K/V; the "
                              "JAX package's own chunked and Pallas "
                              "forwards differ by up to 0.79 of max|logit| "
                              "2.97 over a prefill and 3 decode steps on "
                              "bf16 frames (seen: port 0.84; from the same "
                              "cache state a decode step differs by 0.025)"),
    # the vision-language family (reduced llama-3.2-vision at the
    # reference's init: the cross attention's k and v are drawn at fan-in
    # over the KV-head axis, 2 wide, so the cross K/V reach ~27 and the
    # self K/V ~20; a decode step carries the prefill's rounding through
    # the self KV cache). Readings: `python tests/test_torch_vlm.py`
    "logits_f32_vlm": Tol(1e-5, 3e-5,
                          "atol is relative to max|ref|: f32 sums in "
                          "another order move the ~20-sized self K/V by "
                          "~4e-6 of it, and a decode step sums logits out "
                          "of that residual (seen over 6 seeds: 1.9e-5 "
                          "relative over a prefill and 3 decode steps, "
                          "9.8e-6 for one decode step from the same cache "
                          "state)"),
    "logits_bf16_vlm": Tol(0.1, 0.3,
                           "atol is relative to max|ref|, past rtol: one "
                           "bf16 ulp of the self K/V is 0.125 there; the "
                           "JAX package's own chunked and Pallas "
                           "forwards, fed the same tokens, differ by up to "
                           "0.26 of max|logit| over a prefill and 3 "
                           "decode steps on f32 images (seen: port 0.22)"),
    # training, port against the JAX package on the CPU
    # (tests/test_torch_train_grads.py, tests/test_torch_train.py)
    "loss_f32": Tol(1e-6, 0.0,
                    "a mean of f32 per-token losses summed in another "
                    "order (seen: 1.1e-7 relative over 7 archs x 3 seeds)"),
    "loss_bf16": Tol(2e-3, 0.0,
                     "bf16 logits round at other places in the two "
                     "frameworks (seen: 1.0e-3 relative, reduced mamba2, "
                     "whose random init gives a loss of ~35)"),
    "grads_f32": Tol(0.0, 5e-4,
                     "atol is relative to max|ref| of each gradient leaf: "
                     "f32 sums in another order through the backward of "
                     "2-4 layers (seen over 7 archs x 3 seeds: 2.3e-4 for "
                     "whisper's ~50-sized residual, 7.4e-5 elsewhere)"),
    "grads_bf16": Tol(2.0, 0.05,
                      "per gradient leaf, |got - ref| (Frobenius) at most "
                      "rtol x the reference's own bf16 error (its bf16 "
                      "gradient against its f32 one on the same inputs) + "
                      "atol x |ref|: bf16 gradients of a random reduced "
                      "model are noise-dominated for some leaves (the "
                      "reference's own bf16 reads 2.7x |ref| away from its "
                      "f32 at whisper's dec/attn/k), and a flipped top-k "
                      "routes a token to another expert (seen: 1.79x, "
                      "deepseek-v2's moe/up; 1.3x elsewhere)"),
    "flash_vjp_bf16": Tol(2 ** -7, 2 ** -8,
                          "the reference's rounding points: one bf16 ulp "
                          "where f32 sums in another order round the other "
                          "way (seen: 2 of 12 gradients off by one ulp, the "
                          "rest bit-equal)"),
    "adamw_f32": Tol(4e-6, 1e-7,
                     "the reference's f32 arithmetic op for op; XLA's and "
                     "torch's pow and cos differ in the last bit, and the "
                     "global norm sums ~10**5 squares in another order "
                     "(seen: 1.5e-6)"),
    "grad_norm_f32": Tol(1e-3, 0.0,
                         "the global norm of f32 gradients after Adam steps "
                         "that differ where m / sqrt(v) divides tiny "
                         "moments (seen: 5e-4 at step 2)"),
    "params_after_steps_f32": Tol(0.0, 0.25,
                                  "atol in units of lr_peak: Adam divides m "
                                  "by sqrt(v), so where both are tiny an f32 "
                                  "gradient summed in another order moves "
                                  "the step by a share of lr (seen: 0.12 lr "
                                  "after 3 steps, in 2e-5 of the elements)"),
    "moments_f32": Tol(0.0, 5e-3,
                       "atol is relative to max|ref| of each leaf: the "
                       "moments of f32 gradients summed in another order "
                       "(seen: 1.2e-3 after 3 steps)"),
    "grad_norm_bf16": Tol(0.35, 0.0,
                          "bf16 gradients of a random reduced model: the "
                          "reference's own bf16 norm is 5% off its f32 one "
                          "at step 1, and once the two packages' Adam steps "
                          "differ in sign where their bf16 gradients do, "
                          "the norms drift apart (seen: 28% at step 3)"),
    "params_after_steps_bf16": Tol(0.0, 4.0,
                                   "atol in units of the summed learning "
                                   "rates: where the two packages' bf16 "
                                   "gradients differ in sign, Adam moves a "
                                   "weight by up to lr the other way each "
                                   "step (seen: 1.9x the sum after 3 "
                                   "steps)"),
    # training on the card (chip_smoke.py phases train_flash_vjp, train)
    "flash_vjp_f32": RmsTol(1e-4, 1e-4,
                            "_FlashVJP in f32 against autograd through "
                            "naive_attention in f32 (no TF32): f32 sums in "
                            "another order over up to 1024 keys"),
    "flash_vjp_bf16_card": RmsTol(2 ** -5, 2 ** -1,
                                  "_FlashVJP in bf16 against autograd "
                                  "through naive_attention in f32 on the "
                                  "same bf16 inputs: the backward "
                                  "recomputes the scores in bf16 and "
                                  "rounds p and ds to bf16 (the "
                                  "reference's rounding points, which the "
                                  "CPU test holds to one ulp), so over "
                                  "1000 random keys a few dq and dk "
                                  "entries land a quarter of the rms off "
                                  "the f32 gradient (seen on the card: "
                                  "0.29 of the rms); the planted backward "
                                  "without delta reads ~80 rms off"),
    "train_remat_card": Tol(0.0, 0.0,
                            "remat recomputes the same kernels on the same "
                            "inputs: equal"),
    "train_resume_card": Tol(0.0, 0.0,
                             "the restored state and batches are the saved "
                             "ones: equal losses"),
    "microbatch_loss": Tol(0.0, 0.05,
                           "microbatches=4 against 1: the reference's own "
                           "bound (tests/test_train_serve.py:47-59); bf16 "
                           "activations and gradients summed in pieces"),
    "microbatch_grads": Tol(0.0, 0.1,
                            "microbatches=4 against 1, the largest |diff| of "
                            "any gradient element: the reference's own "
                            "bound (tests/test_train_serve.py:47-59)"),
    # parallelism, the port on 8 gloo ranks against the reference on 8
    # forced host devices (tests/test_torch_parallel.py); the butterfly,
    # butterfly-2, ring, reduce-scatter, all-gather and compressed_psum
    # shards are bit-equal (each adds in the reference's order)
    "psum_gloo_f32": Tol(1e-6, 1e-6,
                         "the library all-reduce sums the 8 ranks in its "
                         "own order (gloo's schedule against XLA's psum): "
                         "f32 reassociation of 8 terms (seen: 4.8e-7 on "
                         "sums of 8 N(0, 1) values)"),
    "compressed_error_jit_f32": Tol(0.0, 2 ** -22,
                                    "the error carry x - q * scale of "
                                    "compressed_psum inside the reference's "
                                    "jitted make_grad_sync: XLA fuses the "
                                    "product and the difference into one "
                                    "FMA, which skips the rounding of "
                                    "q * scale, so the two carries differ "
                                    "by an ulp of x where they differ (x "
                                    "below 4 here: 2**-22; seen 7.3e-8); "
                                    "eager shard_map rounds the product "
                                    "and is bit-equal"),
    "sharded_loss_f32": Tol(1e-6, 0.0,
                            "the sharded step against the unsharded port: "
                            "the mean's sum split over the data ranks "
                            "(seen: 1e-8 relative)"),
    "sharded_grads_f32": Tol(0.0, 1e-4,
                             "atol is relative to max|ref| of each "
                             "gradient leaf: the sharded step's f32 sums "
                             "split over 2 data and 4 model ranks, "
                             "reassociated through the backward of 2 "
                             "layers (seen: 2.2e-5 at mlp/gate)"),
    # served tokens: where two engines pick different tokens, the
    # reference's top-1 minus top-2 logit at the first differing step must
    # be below atol * max|logit| (a near tie that rounding may flip)
    "token_margin": Tol(0.0, 0.02,
                        "bf16 logits: a few bf16 ulps of the largest logit"),
}

"""Plain PyTorch forward of the Llama block that Mistral-7B-v0.3 and
Phi-3-mini-4k-instruct share, in float32 with TF32 off.

Written from the published description (the Hugging Face ``MistralForCausalLM``
and ``Phi3ForCausalLM`` modelling): token embedding; per layer RMSNorm,
q / k / v projections, rotary embedding on q and k (rotate-half, inverse
frequencies theta^(-2i / head_dim)), causal softmax attention with each KV
head serving its group of query heads, the output projection and a residual;
RMSNorm, SwiGLU (down(silu(gate(x)) * up(x))) and a residual; a final RMSNorm
and the output head. Departures: none of the mathematics; Phi-3's fused qkv
and gate_up projections are held split, which computes the same.

It imports nothing of the program: it takes the benchmark's own weights
(``arch/llama.py``, drawn through ``weights.py``), remade here layer by
layer from the seed, and the token ids. It runs layer by layer over a list
of sequences, queries in chunks, so that a 4,096-token sequence fits beside
nothing else.

``quant="fp8"`` is the control: every projection's weights (per output
column) and inputs (per row) rounded to float8 e4m3 with a scale, the rest
as above. It is the step below bf16 that a later change could be tempted by.
"""

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..arch import llama

_E4M3_MAX = 448.0
_QUERY_CHUNK = 1024


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along ``dim`` (the
    absolute maximum maps to the format's largest value), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    def __init__(self, shapes: llama.Shapes, rope_theta: float, rms_eps: float, seed: int,
                 device, weight_dtype=torch.bfloat16, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.s = shapes
        self.theta = rope_theta
        self.eps = rms_eps
        self.seed = seed
        self.device = torch.device(device)
        self.quant = quant
        # The weights are remade in the type they are served in, then widened.
        self.weight_dtype = weight_dtype

    # -- pieces ---------------------------------------------------------------

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * w

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [S, in] @ w [in, out]."""
        if self.quant == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [S, heads, head_dim] at positions 0 .. S - 1."""
        hd = x.shape[-1]
        inv = 1.0 / (self.theta ** (torch.arange(0, hd, 2, device=x.device,
                                                 dtype=torch.float64) / hd))
        ang = torch.arange(x.shape[0], device=x.device, dtype=torch.float64)[:, None] * inv
        cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None, :]
        sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None, :]
        half = hd // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos + rot * sin

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Causal attention; q [S, H, D], k / v [S, KVH, D] -> [S, H * D]."""
        s, h, d = q.shape
        group = h // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        out = torch.empty(s, h, d, device=q.device, dtype=torch.float32)
        for a in range(0, s, _QUERY_CHUNK):
            b = min(s, a + _QUERY_CHUNK)
            logits = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) / math.sqrt(d)
            mask = torch.arange(b, device=q.device)[None, :] > torch.arange(a, b, device=q.device)[:, None]
            logits.masked_fill_(mask[None], float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v[:b])
        return out.reshape(s, h * d)

    def _block(self, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        s = self.s
        hd = s.head_dim
        h = self._norm(x, w["attn_norm"])
        q = self._linear(h, w["wq"].reshape(s.dim, -1)).view(-1, s.n_heads, hd)
        k = self._linear(h, w["wk"].reshape(s.dim, -1)).view(-1, s.n_kv_heads, hd)
        v = self._linear(h, w["wv"].reshape(s.dim, -1)).view(-1, s.n_kv_heads, hd)
        attn = self._attention(self._rope(q), self._rope(k), v)
        x = x + self._linear(attn, w["wo"].reshape(-1, s.dim))
        h = self._norm(x, w["ffn_norm"])
        gate = self._linear(h, w["w_gate_up"][:, 0, :])
        up = self._linear(h, w["w_gate_up"][:, 1, :])
        return x + self._linear(F.silu(gate) * up, w["w_down"])

    # -- entry ----------------------------------------------------------------

    @torch.no_grad()
    def logits(self, sequences: Sequence[Sequence[int]], rows: Sequence[Sequence[int]]
               ) -> List[torch.Tensor]:
        """For each sequence, the float32 logits [len(rows_i), vocab] at the
        positions ``rows_i`` (a position's logits predict the next token)."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            outer = {k: t.float() for k, t in llama.outer(
                self.s, self.seed, self.device, self.weight_dtype).items()}
            ids = [torch.as_tensor(list(seq), dtype=torch.long, device=self.device)
                   for seq in sequences]
            xs = [outer["embed"][i] for i in ids]
            for layer in range(self.s.n_layers):
                w = {k: t.float() for k, t in llama.layer(
                    self.s, self.seed, layer, self.device, self.weight_dtype).items()}
                xs = [self._block(x, w) for x in xs]
                del w
            out = []
            for x, r in zip(xs, rows):
                sel = x[torch.as_tensor(list(r), dtype=torch.long, device=self.device)]
                out.append(self._linear(self._norm(sel, outer["final_norm"]), outer["lm_head"]))
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

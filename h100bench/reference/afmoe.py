"""Plain PyTorch forward of the AFMoE block (Arcee's Trinity-Mini), in
float32 with TF32 off.

Written from the layer equations of Arcee's ``AfmoeForCausalLM`` (Hugging
Face ``transformers``, ``models/afmoe/modeling_afmoe.py``), as the
configuration file's ``assumed`` and ``arch/afmoe.py`` state them: the
embedding times sqrt(hidden) (muP); per layer a = RMSNorm_in(h), q, k, v
projections at head_dim, q and k RMSNorm'd per head, rotary embedding
(rotate-half) on the sliding layers alone, causal softmax attention with each
KV head serving its group of query heads, a sliding layer's row over its
last ``sliding_window`` keys; the output times sigmoid(a W_gate), projected,
RMSNorm'd and added; m = RMSNorm(h); a SwiGLU on the dense layers, else the
shared expert plus the routed ones (scores sigmoid(m W_router); the top k of
scores + expert_bias chosen; weights the chosen scores over their sum plus
1e-20, times route_scale), RMSNorm'd and added; a final RMSNorm and the
head. Departures: none of the mathematics; each expert's rows run as one
matmul a projection, and the routed sum adds the experts in expert order.

It imports nothing of the program: it takes the benchmark's own weights
(``arch/afmoe.py``, drawn through ``weights.py``), remade here layer by layer
from the seed, and the token ids. It runs layer by layer over a list of
sequences, queries in chunks, and the experts over the rows of every
sequence at once.

**Near-ties.** A routed layer's choice is a top-k: where two experts'
scores are closer than the program's rounding, bf16 and float32 may choose
differently, and with random weights one such swap changes every later
layer. So where the program recorded its choice for a row and layer
(``program_choices``: token ids -> [rows, layers, k], -1 where none), and
that choice is a top-k of this reference's own scores + bias once each is
moved by at most ``near_tie`` / 2 (its lowest is within ``near_tie`` of the
highest it leaves out), the reference takes the program's experts, weighted
by its own scores. ``adopted`` counts such (row, layer) pairs that differed,
``routed`` all. Anything further apart stays the reference's own choice.
``margins`` keeps, per routed layer, the pairs where the program's choice
differed, those taken, and the widest distance (highest left out less
lowest chosen, on this reference's scores + bias) of a differing choice:
at the first routed layer, where no routing upstream differs, that is the
program's own rounding. ``logits`` prints them to standard error.

``quant="fp8"`` is the control: every projection's weights (per output
column) and inputs (per row) rounded to float8 e4m3 with a scale, the
experts' included; the router keeps float32, as the program's does, and
takes the program's near-ties as above. It is the step below bf16 that a
later change could be tempted by.
"""

import json
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..arch import afmoe

_E4M3_MAX = 448.0
_QUERY_CHUNK = 1024


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along ``dim`` (the
    absolute maximum maps to the format's largest value), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    def __init__(self, shapes: afmoe.Shapes, cfg: dict, seed: int, device,
                 weight_dtype=torch.bfloat16, quant: Optional[str] = None,
                 program_choices: Optional[Callable] = None, near_tie: float = 0.0):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.s = shapes
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.route_scale = float(cfg["route_scale"])
        self.route_norm = bool(cfg["route_norm"])
        self.seed = seed
        self.device = torch.device(device)
        self.quant = quant
        # The weights are remade in the type they are served in, then widened.
        self.weight_dtype = weight_dtype
        self.program_choices = program_choices
        self.near_tie = near_tie
        self.adopted = 0
        self.routed = 0
        self.margins: Dict[int, list] = {}  # layer -> [differed, taken, widest]

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

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int) -> torch.Tensor:
        """Causal attention, a row over its last ``window`` keys (0: all);
        q [S, H, D], k / v [S, KVH, D] -> [S, H * D]."""
        s, h, d = q.shape
        group = h // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        out = torch.empty(s, h, d, device=q.device, dtype=torch.float32)
        for a in range(0, s, _QUERY_CHUNK):
            b = min(s, a + _QUERY_CHUNK)
            lo = max(0, a - window + 1) if window else 0
            logits = torch.einsum("qhd,khd->hqk", q[a:b], k[lo:b]) / math.sqrt(d)
            rows = torch.arange(a, b, device=q.device)[:, None]
            keys = torch.arange(lo, b, device=q.device)[None, :]
            mask = keys > rows
            if window:
                mask |= keys <= rows - window
            logits.masked_fill_(mask[None], float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v[lo:b])
        return out.reshape(s, h * d)

    def _swiglu(self, x: torch.Tensor, w_gate_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
        """down(silu(gate(x)) * up(x)); ``w_gate_up`` [dim, 2, F]."""
        gate = self._linear(x, w_gate_up[:, 0, :])
        up = self._linear(x, w_gate_up[:, 1, :])
        return self._linear(F.silu(gate) * up, w_down)

    def _choose(self, key: torch.Tensor, program: Optional[torch.Tensor],
                layer: int = 0) -> torch.Tensor:
        """[N, k] experts: the top k of ``key``, or the program's where it
        is a near-tie (module docstring); ``layer``: the routed layer."""
        choice = torch.topk(key, self.s.top_k, dim=-1).indices
        self.routed += key.shape[0]
        if program is None:
            return choice
        prog = program.long().clamp(min=0)
        lowest = key.gather(-1, prog).min(-1).values
        left_out = key.scatter(-1, prog, float("-inf")).max(-1).values
        differs = (program >= 0).all(-1) & (
            prog.sort(-1).values != choice.sort(-1).values).any(-1)
        take = differs & (lowest + self.near_tie >= left_out) if self.near_tie > 0 else (
            torch.zeros_like(differs))
        self.adopted += int(take.sum())
        m = self.margins.setdefault(layer, [0, 0, 0.0])
        m[0] += int(differs.sum())
        m[1] += int(take.sum())
        if differs.any():
            m[2] = max(m[2], float((left_out - lowest)[differs].max()))
        return torch.where(take[:, None], prog, choice)

    def margin_summary(self) -> dict:
        """The program's differing choices: over all routed layers and at
        the first, (pairs, taken, widest distance)."""
        if not self.margins:
            return {}
        rows = [self.margins[k] for k in sorted(self.margins)]
        return {"all": [sum(r[0] for r in rows), sum(r[1] for r in rows),
                        max(r[2] for r in rows)],
                "first_routed_layer": list(rows[0]),
                "widest_by_layer": [round(r[2], 6) for r in rows]}

    def _routed(self, m: torch.Tensor, w: Dict[str, torch.Tensor],
                program: Optional[torch.Tensor] = None, layer: int = 0) -> torch.Tensor:
        """The routed experts' weighted sum for the rows ``m`` [N, dim];
        ``program``: the program's [N, k] choices (-1: none) at routed
        layer ``layer``."""
        scores = torch.sigmoid(m @ w["router"])  # float32, as the program's router
        choice = self._choose(scores + w["expert_bias"], program, layer)
        weight = scores.gather(-1, choice)
        if self.route_norm:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        weight = weight * self.route_scale
        out = torch.zeros_like(m)
        for e in torch.unique(choice).tolist():
            r, j = (choice == e).nonzero(as_tuple=True)
            y = self._swiglu(m[r], w["w_gate_up_moe"][e], w["w_down_moe"][e])
            out.index_add_(0, r, y * weight[r, j][:, None])
        return out

    def _attend(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
                sliding: bool) -> torch.Tensor:
        s = self.s
        hd = s.head_dim
        a = self._norm(x, w["attn_norm"])
        q = self._norm(self._linear(a, w["wq"].reshape(s.dim, -1)).view(-1, s.n_heads, hd),
                       w["q_norm"])
        k = self._norm(self._linear(a, w["wk"].reshape(s.dim, -1)).view(-1, s.n_kv_heads, hd),
                       w["k_norm"])
        v = self._linear(a, w["wv"].reshape(s.dim, -1)).view(-1, s.n_kv_heads, hd)
        if sliding:
            q, k = self._rope(q), self._rope(k)
        attn = self._attention(q, k, v, s.window if sliding else 0)
        attn = attn * torch.sigmoid(self._linear(a, w["w_attn_gate"].reshape(s.dim, -1)))
        out = self._linear(attn, w["wo"].reshape(-1, s.dim))
        return x + self._norm(out, w["post_attn_norm"])

    def _ffn(self, x: torch.Tensor, w: Dict[str, torch.Tensor], dense: bool,
             program: Optional[torch.Tensor] = None, layer: int = 0) -> torch.Tensor:
        m = self._norm(x, w["ffn_norm"])
        if dense:
            f = self._swiglu(m, w["w_gate_up"], w["w_down"])
        else:
            f = (self._swiglu(m, w["w_gate_up_shared"], w["w_down_shared"])
                 + self._routed(m, w, program, layer))
        return x + self._norm(f, w["post_ffn_norm"])

    def _program_rows(self, sequences) -> Optional[torch.Tensor]:
        """The program's choices for every row of ``sequences``, [rows,
        routed layers, k] (-1 where it recorded none), or None."""
        if self.program_choices is None:
            return None
        parts = [self.program_choices(list(seq)) for seq in sequences]
        if any(p is None for p in parts):
            return None
        return torch.as_tensor(np.concatenate(parts), device=self.device)

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
            s = self.s
            outer = {k: t.float() for k, t in afmoe.outer(
                s, self.seed, self.device, self.weight_dtype).items()}
            ids = [torch.as_tensor(list(seq), dtype=torch.long, device=self.device)
                   for seq in sequences]
            xs = [outer["embed"][i] * math.sqrt(s.dim) for i in ids]
            lens = [x.shape[0] for x in xs]
            program = self._program_rows(sequences)
            for layer in range(s.n_layers):
                w = {k: t.float() for k, t in afmoe.layer(
                    s, self.seed, layer, self.device, self.weight_dtype).items()}
                sliding = s.layer_types[layer] == afmoe.SLIDING
                xs = [self._attend(x, w, sliding) for x in xs]
                routed = layer - s.n_dense
                x = self._ffn(torch.cat(xs), w, layer < s.n_dense,
                              None if program is None or routed < 0 else program[:, routed],
                              routed)
                xs = list(torch.split(x, lens))
                del w
            out = []
            for x, r in zip(xs, rows):
                sel = x[torch.as_tensor(list(r), dtype=torch.long, device=self.device)]
                out.append(self._linear(self._norm(sel, outer["final_norm"]), outer["lm_head"]))
            if program is not None:
                print(f"afmoe reference{' (fp8)' if self.quant else ''}: took the program's "
                      f"experts at {self.adopted} of {self.routed} routed (row, layer) pairs, "
                      f"near-tie {self.near_tie}; the program's choice differed "
                      f"{json.dumps(self.margin_summary())}", file=sys.stderr)
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

"""The served model, worked out again in plain PyTorch: a decoder of
pre-norm blocks (RMSNorm, GQA attention with RoPE and optional qk-norm,
a SwiGLU MLP or a top-k mixture of experts with per-call capacity) whose
every dense product is the configuration's TD macro (`td.TDMacro`).

The check follows the engine from its own state.  A 4-bit network of
this depth with random weights is chaotic: a one-ulp difference in a
bf16 attention output flips a code a few layers on and, within a dozen
layers, the served token (PERF.md, "How correct is decided").  So each
row is recomputed on its own: through every layer, its attention reads
the keys and values that the engine's KV cache holds for the positions
before it (the program's state), and its own.  A difference then
reaches only the row it starts in.  What the cache holds is checked
against the rows that wrote it: each recomputed row's own keys and
values at every layer.

A row is computed at the coordinates the engine computed it at: a
prompt row p of an admission at row p of a call of the bucket's M rows,
a decode row at its slot of a call of all the engine's slots.  The
mixture of experts routes and slots the rows of one call together, as
the engine does, so a call's rows are all recomputed or none is; an
admission's pad rows take their context from the prompt's cached rows
and from each other (the engine overwrites their cache).

Arithmetic follows the configuration's dtype (bf16) at the points where
the served model rounds; attention and softmax run in float32.  ``rnd``,
applied at each of those points, is the identity for the reference and
a lower precision for the control (`judge.fp8`).
"""
from __future__ import annotations

import dataclasses

import torch

BF16 = torch.bfloat16


@dataclasses.dataclass
class Row:
    """One recomputed row.  ``kind`` 0: an admission's prompt or pad row
    (noise row ``m`` = its position, of the bucket's rows), 1: a decode
    row (``m`` = its slot, of the engine's slots).  ``ctx`` keys of the
    slot's context precede it; ``judge`` the token it served, or -1;
    ``kv`` whether the cache holds what this row wrote."""
    slot: int
    pos: int
    tok: int
    kind: int
    m: int
    call: tuple
    ctx: int
    judge: int = -1
    kv: bool = True
    own_ctx: bool = False


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, H, D) at positions pos (R,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos[:, None].to(torch.float32) * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-x)))


def attend(q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
           n_ctx: torch.Tensor, k_self: torch.Tensor,
           v_self: torch.Tensor) -> torch.Tensor:
    """GQA attention of rows q (R, Hq, D) over the first ``n_ctx[i]`` keys
    of k_ctx / v_ctx (S, Hkv, D) and their own k_self / v_self (R, Hkv,
    D), in float32.  Returns (R, Hq, D) in q's dtype."""
    r, hq, d = q.shape
    hkv = k_ctx.shape[1]
    g = hq // hkv
    qf = q.to(torch.float32).reshape(r, hkv, g, d) * (d ** -0.5)
    s = torch.einsum("rkgd,tkd->rkgt", qf, k_ctx.to(torch.float32))
    keep = torch.arange(k_ctx.shape[0], device=q.device)[None, :] \
        < n_ctx[:, None]
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    s_self = torch.einsum("rkgd,rkd->rkg", qf, k_self.to(torch.float32))
    p = torch.softmax(torch.cat([s, s_self[..., None]], dim=-1), dim=-1)
    o = torch.einsum("rkgt,tkd->rkgd", p[..., :-1], v_ctx.to(torch.float32))
    o = o + p[..., -1:] * v_self.to(torch.float32)[:, :, None, :]
    return o.reshape(r, hq, d).to(q.dtype)


class Rows:
    """The rows of one check and the program's cache they read.

    ``cache[slot]``: (K, V), each (layers, S, Hkv, D), the engine's cache
    of that slot's positions at the moment the rows' calls had run."""

    def __init__(self, rows: list[Row], cache: dict, prompt_pad: int,
                 slots: int, device):
        self.rows, self.cache, self.device = rows, cache, device
        dev = device
        t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa
        self.tok = t([r.tok for r in rows])
        self.pos = t([r.pos for r in rows])
        self.kind = t([r.kind for r in rows])
        self.row = t([r.m for r in rows])
        self.m_of_kind = (prompt_pad, slots)
        self.by_slot: dict[int, torch.Tensor] = {}
        for i, r in enumerate(rows):
            self.by_slot.setdefault(r.slot, []).append(i)
        self.by_slot = {s: t(v) for s, v in self.by_slot.items()}
        self.n_ctx = t([r.ctx for r in rows])
        self.own_ctx = [i for i, r in enumerate(rows) if r.own_ctx]
        groups: dict = {}
        for i, r in enumerate(rows):
            groups.setdefault(r.call, []).append(i)
        self.calls = [(c[0], t(sorted(v, key=lambda i: rows[i].m)))
                      for c, v in groups.items()]
        self.judged = [i for i, r in enumerate(rows) if r.judge >= 0]
        self.kv_rows = t([i for i, r in enumerate(rows) if r.kv])


class Model:
    """The decoder at one configuration: ``mc`` the model's sizes (the
    configuration file's ``model_cfg``), ``params`` the benchmark's
    weights, ``td`` the macro."""

    def __init__(self, mc: dict, params: dict, td, rnd=None):
        self.mc, self.p, self.td = mc, params, td
        self.rnd = rnd if rnd is not None else (lambda t: t)

    # ---- products ---------------------------------------------------------
    def dense(self, lin: dict, h: torch.Tensor, rs: Rows) -> torch.Tensor:
        """A dense over the rows, each kind of call at its geometry."""
        w, s_a, s_w = lin["w"], lin["s_a"], lin["s_w"]
        wc = self.td.codes(w, s_w, self.td.bits_w)
        out = torch.empty((h.shape[0], w.shape[1]), dtype=BF16,
                          device=h.device)
        for k in (0, 1):
            at = torch.nonzero(rs.kind == k)[:, 0]
            if at.numel():
                out[at] = self.td.linear(h[at], w, s_a, s_w, rs.row[at],
                                         rs.m_of_kind[k], wc=wc)
        return self.rnd(out)

    # ---- blocks -----------------------------------------------------------
    def attention(self, li: int, lp: dict, h: torch.Tensor, rs: Rows,
                  kv_out: list) -> torch.Tensor:
        mc = self.mc
        hq, hkv, hd = mc["n_heads"], mc["n_kv_heads"], mc["head_dim"]
        r = h.shape[0]
        q = self.dense(lp["wq"], h, rs).reshape(r, hq, hd)
        k = self.dense(lp["wk"], h, rs).reshape(r, hkv, hd)
        v = self.dense(lp["wv"], h, rs).reshape(r, hkv, hd)
        if mc.get("qk_norm"):
            q = rmsnorm(q, lp["q_norm"]["scale"], mc["rms_eps"])
            k = rmsnorm(k, lp["k_norm"]["scale"], mc["rms_eps"])
        q = self.rnd(rope(q, rs.pos, mc["rope_theta"]))
        k = self.rnd(rope(k, rs.pos, mc["rope_theta"]))
        kv_out.append((k[rs.kv_rows], v[rs.kv_rows]))
        o = torch.empty_like(q)
        for slot, idx in rs.by_slot.items():
            kc, vc = rs.cache[slot]
            kc, vc = self.rnd(kc[li]), self.rnd(vc[li])
            own = [i for i in idx.tolist() if rs.rows[i].own_ctx]
            if own:
                # rows whose cache the engine overwrote: their own k, v
                kc, vc = kc.clone(), vc.clone()
                at = torch.tensor(own, device=h.device)
                kc[rs.pos[at]] = k[at]
                vc[rs.pos[at]] = v[at]
            o[idx] = attend(q[idx], kc, vc, rs.n_ctx[idx], k[idx], v[idx])
        return self.dense(lp["wo"], self.rnd(o).reshape(r, hq * hd), rs)

    def mlp(self, lp: dict, h: torch.Tensor, rs: Rows) -> torch.Tensor:
        a = self.rnd(silu(self.dense(lp["wg"], h, rs))
                     * self.dense(lp["wi"], h, rs))
        return self.dense(lp["wo"], a, rs)

    def moe(self, lp: dict, h: torch.Tensor, rs: Rows) -> torch.Tensor:
        """Route and slot each call's rows as the engine does (a stable
        top-k of the router's softmax, a stable sort by expert, overflow
        past the call's capacity dropped); each expert's rows of every call
        through its three products; each row's kept experts summed in
        expert order, weighted by the normalized router probability."""
        mo = self.mc["moe"]
        e_n, top = mo["num_experts"], mo["top_k"]
        dev = h.device
        tok_l, exp_l, rank_l, wt_l, cap_l = [], [], [], [], []
        for _, idx in rs.calls:
            t = idx.numel()
            cap = max(top, min(int(-(-t * top * mo["capacity_factor"]
                                     // e_n)), t))
            logits = (h[idx] @ lp["router"]["w"]).to(torch.float32)
            ex = torch.exp(logits - logits.amax(-1, keepdim=True))
            probs = ex / ex.sum(-1, keepdim=True)
            vals, ids = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
            top_p, top_e = vals[:, :top], ids[:, :top]
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                        min=1e-9)
            sorted_e, order = torch.sort(top_e.reshape(-1), stable=True)
            start = torch.searchsorted(sorted_e,
                                       torch.arange(e_n, device=dev))
            rank = torch.arange(t * top, device=dev) - start[sorted_e]
            keep = rank < cap
            tok_l.append(idx[(order // top)[keep]])
            exp_l.append(sorted_e[keep])
            rank_l.append(rank[keep])
            wt_l.append(top_p.reshape(-1)[order][keep])
            cap_l.append(torch.full((int(keep.sum()),), cap, device=dev))
        tok, expert = torch.cat(tok_l), torch.cat(exp_l)
        rank, wt, cap = torch.cat(rank_l), torch.cat(wt_l), torch.cat(cap_l)
        ys = torch.empty((tok.numel(), h.shape[1]), dtype=BF16, device=dev)
        for e in range(e_n):
            mine = torch.nonzero(expert == e)[:, 0]
            if mine.numel() == 0:
                continue
            xe = h[tok[mine]]
            wcs = {nm: self.td.codes(lp[nm][e], lp[f"s_{nm}"],
                                     self.td.bits_w)
                   for nm in ("wg", "wi", "wo")}
            out = torch.empty((mine.numel(), h.shape[1]), dtype=BF16,
                              device=dev)
            for c in torch.unique(cap[mine]).tolist():
                at = torch.nonzero(cap[mine] == c)[:, 0]
                rows = rank[mine][at]

                def lin(x, nm):
                    return self.rnd(self.td.linear(
                        x, lp[nm][e], lp["s_a"], lp[f"s_{nm}"], rows, int(c),
                        wc=wcs[nm]))
                a = self.rnd(silu(lin(xe[at], "wg")) * lin(xe[at], "wi"))
                out[at] = lin(a, "wo")
            ys[mine] = out
            del wcs
        contrib = ys * wt[:, None].to(BF16)
        # each row's kept experts in expert order, summed in bf16 from 0
        order = torch.argsort(tok * e_n + expert)
        tok_s, contrib = tok[order], contrib[order]
        first = torch.ones_like(tok_s, dtype=torch.bool)
        first[1:] = tok_s[1:] != tok_s[:-1]
        grp = torch.cumsum(first.to(torch.int64), 0) - 1
        nth = torch.arange(tok_s.numel(), device=dev) \
            - torch.nonzero(first)[:, 0][grp]
        y = torch.zeros_like(h)
        for j in range(top):
            at = torch.nonzero(nth == j)[:, 0]
            y[tok_s[at]] = y[tok_s[at]] + contrib[at]
        return self.rnd(y)

    # ---- the whole recomputation ------------------------------------------
    @torch.no_grad()
    def run(self, rs: Rows, block: int = 256):
        """(logits of the judged rows (J, V) in the compute dtype, the
        rows' own keys and values at each layer [(K, V)] for the rows
        whose write the cache holds)."""
        mc, p = self.mc, self.p
        x = self.rnd(p["embed"]["table"][rs.tok])
        kv: list = []
        for li, lp in enumerate(p["layers"]):
            h = self.rnd(rmsnorm(x, lp["ln1"]["scale"], mc["rms_eps"]))
            x = self.rnd(x + self.attention(li, lp["attn"], h, rs, kv))
            h = self.rnd(rmsnorm(x, lp["ln2"]["scale"], mc["rms_eps"]))
            y = self.moe(lp["moe"], h, rs) if "moe" in lp \
                else self.mlp(lp["mlp"], h, rs)
            x = self.rnd(x + y)
        at = torch.tensor(rs.judged, dtype=torch.int64, device=x.device)
        hid = self.rnd(rmsnorm(x[at], p["final_norm"]["scale"],
                               mc["rms_eps"]))
        lin = p["lm_head"]
        wc = self.td.codes(lin["w"], lin["s_w"], self.td.bits_w)
        out = torch.empty((hid.shape[0], lin["w"].shape[1]), dtype=BF16,
                          device=hid.device)
        kinds, rows = rs.kind[at], rs.row[at]
        for k in (0, 1):
            sel = torch.nonzero(kinds == k)[:, 0]
            for c0 in range(0, sel.numel(), block):
                s = sel[c0:c0 + block]
                out[s] = self.td.linear(hid[s], lin["w"], lin["s_a"],
                                        lin["s_w"], rows[s],
                                        rs.m_of_kind[k], wc=wc)
        del wc
        return self.rnd(out), kv

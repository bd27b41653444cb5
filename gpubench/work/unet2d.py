"""Operations and bytes of one UNet2DConditionModel evaluation, from the
configuration's shapes alone.

Every matmul-like call of the evaluation is listed with its kind
("attention", "conv3x3", "conv1x1", "linear"), its floating-point
operations (2 per multiply-add; attention: QK^T and PV) and the bytes it
must move at the least: each input read once and each output written once,
at the served width (bf16: 2 bytes). The sum of the operations is the
model's operations per evaluation, the count a FLOP counter gives for the
model (elementwise work, norms and softmax are not counted).
"""

from __future__ import annotations

UP = {"DownBlock2D": "UpBlock2D", "CrossAttnDownBlock2D": "CrossAttnUpBlock2D"}


def _heads(u, c):
    return u.get("fixed_num_heads") or c // u["attention_head_dim"]


def _mid_layers(u):
    if u.get("mid_block_layers") is not None:
        return u["mid_block_layers"]
    depth = u["transformer_layers_per_block"][0]
    for t, d in zip(u["down_block_types"], u["transformer_layers_per_block"]):
        if t == "CrossAttnDownBlock2D":
            depth = d
    return depth


class _Calls:
    def __init__(self, batch, width_bytes):
        self.b, self.e = batch, width_bytes
        self.calls: list[dict] = []

    def conv(self, h, w, cin, cout, k=3, stride=1, residual=False):
        """A conv on a (b, h, w, cin) input; the output is (h / stride, w / stride)."""
        ho, wo = h // stride, w // stride
        out = self.b * ho * wo * cout
        moved = (self.b * h * w * cin + k * k * cin * cout + out * (2 if residual else 1))
        self.calls.append({"kind": f"conv{k}x{k}",
                           "flops": 2 * out * cin * k * k, "bytes": self.e * moved + 4 * cout})

    def linear(self, rows, cin, cout):
        self.calls.append({"kind": "linear", "flops": 2 * rows * cin * cout,
                           "bytes": self.e * (rows * cin + cin * cout + rows * cout)})

    def attention(self, sq, sk, heads, d):
        b = self.b
        self.calls.append({"kind": "attention", "flops": 4 * b * heads * sq * sk * d,
                           "bytes": self.e * b * heads * d * (2 * sq + 2 * sk)})

    def resnet(self, h, w, cin, cout, temb):
        self.conv(h, w, cin, cout)
        self.linear(self.b, temb, cout)
        if cin != cout:
            self.conv(h, w, cin, cout, k=1)
        self.conv(h, w, cout, cout, residual=True)

    def transformer(self, h, w, c, u, layers, ctx_len):
        s = h * w
        rows = self.b * s
        heads = _heads(u, c)
        ctx = u["cross_attention_dim"]
        self.linear(rows, c, c)  # proj_in
        for _ in range(layers):
            for _ in range(3):
                self.linear(rows, c, c)  # attn1 q, k, v
            self.attention(s, s, heads, c // heads)
            self.linear(rows, c, c)  # attn1 out
            self.linear(rows, c, c)  # attn2 q
            self.linear(self.b * ctx_len, ctx, c)  # attn2 k
            self.linear(self.b * ctx_len, ctx, c)  # attn2 v
            self.attention(s, ctx_len, heads, c // heads)
            self.linear(rows, c, c)  # attn2 out
            self.linear(rows, c, 8 * c)  # GEGLU projection
            self.linear(rows, 4 * c, c)
        self.linear(rows, c, c)  # proj_out


def unet_calls(u: dict, batch: int, lat_h: int, lat_w: int, ctx_len: int = 77,
               width_bytes: int = 2) -> list[dict]:
    """The calls of one evaluation of a ``batch``-row UNet (under CFG the
    doubled batch) on (lat_h, lat_w) latents with ``ctx_len`` context tokens."""
    k = _Calls(batch, width_bytes)
    ch = u["block_out_channels"]
    temb = 4 * ch[0]
    k.linear(batch, ch[0], temb)
    k.linear(batch, temb, temb)
    if u.get("projection_class_embeddings_input_dim") is not None:
        k.linear(batch, u["projection_class_embeddings_input_dim"], temb)
        k.linear(batch, temb, temb)
    h, w = lat_h, lat_w
    k.conv(h, w, u["in_channels"], ch[0])
    skips = [ch[0]]
    cin = ch[0]
    n = len(ch)
    for i, kind in enumerate(u["down_block_types"]):
        for _ in range(u["layers_per_block"]):
            k.resnet(h, w, cin, ch[i], temb)
            cin = ch[i]
            if kind == "CrossAttnDownBlock2D":
                k.transformer(h, w, cin, u, u["transformer_layers_per_block"][i], ctx_len)
            skips.append(cin)
        if i < n - 1:
            k.conv(h, w, cin, cin, stride=2)
            h, w = h // 2, w // 2
            skips.append(cin)
    k.resnet(h, w, cin, cin, temb)
    k.transformer(h, w, cin, u, _mid_layers(u), ctx_len)
    k.resnet(h, w, cin, cin, temb)
    rev = list(reversed(ch))
    depths = list(reversed(u["transformer_layers_per_block"]))
    for i, t in enumerate(u["down_block_types"][::-1]):
        for _ in range(u["layers_per_block"] + 1):
            k.resnet(h, w, cin + skips.pop(), rev[i], temb)
            cin = rev[i]
            if UP[t] == "CrossAttnUpBlock2D":
                k.transformer(h, w, cin, u, depths[i], ctx_len)
        if i < n - 1:
            h, w = 2 * h, 2 * w
            k.conv(h, w, cin, cin)
    k.conv(h, w, ch[0], u["out_channels"])
    return k.calls


def evaluation_flops(u: dict, batch: int, lat_h: int, lat_w: int, ctx_len: int = 77) -> int:
    """The model's operations in one evaluation."""
    return sum(c["flops"] for c in unet_calls(u, batch, lat_h, lat_w, ctx_len))

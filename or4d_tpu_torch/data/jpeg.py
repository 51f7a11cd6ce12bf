"""A baseline JPEG decoder owned by the port (the 4D-OR camera frames).

The machine the port runs on has no image library, so the port decodes the
release's ``colorimage/*.jpg`` itself. Scope: baseline and extended
sequential Huffman-coded JPEG (SOF0/SOF1), 8-bit samples, one component
(grey) or three (YCbCr) with 4:4:4 or 4:2:0 sampling, interleaved or not,
with or without restart markers. A progressive, lossless, hierarchical or
arithmetic-coded file, 12-bit samples or another sampling raise a
:class:`JpegError` that names what the file is.

The arithmetic is libjpeg's defaults, which PIL decodes with, so the pixels
are PIL's bit for bit:

* the entropy decoding runs on the host, in Python (one Huffman lookup of
  16 bits a symbol), and yields the quantised coefficients;
* dequantisation and the ``islow`` integer IDCT (jidctint.c: 13-bit
  constants, 2 pass-1 bits, its range-limit table), the "fancy" triangle
  upsampling of 4:2:0 chroma (jdsample.c ``h2v2_fancy_upsample``, edges
  replicated) and the fixed-point YCbCr -> RGB tables (jdcolor.c, 16
  scale bits) are integer tensor ops, on the device the caller names.

:func:`decode_jpeg` returns (H, W, 3) uint8 RGB, as ``PIL.Image.open(path)
.convert("RGB")`` gives it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


class JpegError(ValueError):
    """A file this decoder does not take, or a malformed one."""


# zig-zag scan position -> natural (row-major) index within the 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63], np.int64)

_UNSUPPORTED_SOF = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


def _huffman_lut(counts: bytes, symbols: bytes) -> list[int]:
    """A 16-bit lookup: the next 16 bits of the stream -> symbol << 8 |
    code length (0 where no code matches)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (symbols[k] << 8) | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, start: int) -> tuple[list[bytes], int]:
    """The entropy-coded data of one scan from ``start``: its restart
    intervals with the stuffed 0x00 after each 0xFF removed, and the
    position of the marker that ends the scan."""
    segs, seg_start, i, n = [], start, start, len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise JpegError("entropy-coded data runs past the end of the file")
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:  # a stuffed byte, or fill before a marker
            i += 1 if m == 0xFF else 2
            continue
        segs.append(data[seg_start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:  # RSTn
            seg_start = i = i + 2
            continue
        return segs, i


class _Frame:
    def __init__(self, body: bytes):
        precision, self.height, self.width, nc = body[0], int.from_bytes(body[1:3], "big"), \
            int.from_bytes(body[3:5], "big"), body[5]
        if precision != 8:
            raise JpegError(f"{precision}-bit samples: only 8-bit JPEG is decoded")
        if self.height == 0 or self.width == 0:
            raise JpegError("a frame of zero lines or columns (DNL) is not supported")
        self.comps = []
        for c in range(nc):
            cid, hv, tq = body[6 + 3 * c], body[7 + 3 * c], body[8 + 3 * c]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        if nc not in (1, 3):
            raise JpegError(f"{nc} components: only greyscale (1) or YCbCr (3) is decoded")
        self.hmax = max(c["h"] for c in self.comps)
        self.vmax = max(c["v"] for c in self.comps)
        sampling = tuple((c["h"], c["v"]) for c in self.comps)
        if nc == 3 and sampling not in (((1, 1),) * 3, ((2, 2), (1, 1), (1, 1))):
            raise JpegError(f"sampling factors {sampling}: only 4:4:4 and 4:2:0 are decoded")
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            c["bw"], c["bh"] = self.mcux * c["h"], self.mcuy * c["v"]  # blocks, MCU-padded
            c["w"] = -(-self.width * c["h"] // self.hmax)  # samples
            c["hgt"] = -(-self.height * c["v"] // self.vmax)
            c["coef"] = np.zeros((c["bh"] * c["bw"], 64), np.int64)  # zig-zag order


def _decode_scan(frame: _Frame, comps: list[dict], segs: list[bytes], restart: int) -> None:
    """Huffman-decode one scan's coefficients into its components."""
    interleaved = len(comps) > 1
    if interleaved:
        units = []  # per MCU: (component, block row offset, block col offset) in order
        for c in comps:
            for v in range(c["v"]):
                for h in range(c["h"]):
                    units.append((c, v, h))
        n_mcu, mcux = frame.mcux * frame.mcuy, frame.mcux
    else:
        c = comps[0]
        bw, bh = -(-c["w"] // 8), -(-c["hgt"] // 8)
        n_mcu, mcux = bw * bh, bw
    per_seg = restart if restart else n_mcu
    if len(segs) != -(-n_mcu // per_seg):
        raise JpegError(f"{len(segs)} restart intervals where {-(-n_mcu // per_seg)} were expected")
    mcu = 0
    for seg in segs:
        buf = np.frombuffer(seg + b"\x00\x00\x00\x00", np.uint8).astype(np.int64)
        win = ((buf[:-2] << 16) | (buf[1:-1] << 8) | buf[2:]).tolist()
        limit = 8 * len(seg)
        pos = 0
        preds = {id(c): 0 for c in comps}
        for _ in range(min(per_seg, n_mcu - mcu)):
            my, mx = divmod(mcu, mcux)
            blocks = units if interleaved else ((comps[0], 0, 0),)
            for c, v, h in blocks:
                if interleaved:
                    row, col = my * c["v"] + v, mx * c["h"] + h
                else:
                    row, col = my, mx
                out = c["coef"][row * c["bw"] + col]
                dc, ac = c["dc_lut"], c["ac_lut"]
                w = win[pos >> 3]
                e = dc[(w >> (8 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise JpegError("corrupt Huffman code (DC)")
                pos += e & 0xFF
                s = e >> 8
                diff = 0
                if s:
                    diff = ((win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                    pos += s
                    if diff < (1 << (s - 1)):
                        diff -= (1 << s) - 1
                preds[id(c)] += diff
                out[0] = preds[id(c)]
                k = 1
                while k < 64:
                    e = ac[(win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise JpegError("corrupt Huffman code (AC)")
                    pos += e & 0xFF
                    rs = e >> 8
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r != 15:
                            break  # end of block
                        k += 16
                        continue
                    k += r
                    val = ((win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                    pos += s
                    if val < (1 << (s - 1)):
                        val -= (1 << s) - 1
                    if k > 63:
                        raise JpegError("corrupt AC run past the block's end")
                    out[k] = val
                    k += 1
            mcu += 1
        if pos > limit + 16:
            raise JpegError("entropy-coded data ended inside a block")


def parse_jpeg(data: bytes) -> _Frame:
    """The frame with every component's quantised coefficients (zig-zag
    order, one row a block) and quantiser (``coef``, ``q``)."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG file (no SOI marker)")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, scans, i = None, 0, 0, 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise JpegError(f"expected a marker at byte {i}")
        m = data[i + 1]
        if m == 0xFF:
            i += 1
            continue
        if m == 0xD9:  # EOI
            break
        seglen = int.from_bytes(data[i + 2:i + 4], "big")
        body = data[i + 4:i + 2 + seglen]
        i += 2 + seglen
        if m == 0xDB:  # DQT
            j = 0
            while j < len(body):
                pq, tq = body[j] >> 4, body[j] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[j + 1:j + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
                qt[tq] = vals  # zig-zag order
                j += 1 + n
        elif m == 0xC4:  # DHT
            j = 0
            while j < len(body):
                tc, th = body[j] >> 4, body[j] & 15
                counts = body[j + 1:j + 17]
                n = sum(counts)
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts, body[j + 17:j + 17 + n])
                j += 17 + n
        elif m == 0xDD:  # DRI
            restart = int.from_bytes(body[:2], "big")
        elif m in (0xC0, 0xC1):
            frame = _Frame(body)
        elif m in _UNSUPPORTED_SOF:
            raise JpegError(f"{_UNSUPPORTED_SOF[m]} JPEG: only baseline/extended sequential Huffman is decoded")
        elif m == 0xDA:  # SOS
            if frame is None:
                raise JpegError("a scan before the frame header")
            ns = body[0]
            comps = []
            for k in range(ns):
                cid, td_ta = body[1 + 2 * k], body[2 + 2 * k]
                c = next((c for c in frame.comps if c["id"] == cid), None)
                if c is None:
                    raise JpegError(f"scan names component {cid}, which the frame does not have")
                c["dc_lut"], c["ac_lut"] = dc_tabs[td_ta >> 4], ac_tabs[td_ta & 15]
                comps.append(c)
            ss, se, ahl = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            if (ss, se, ahl) != (0, 63, 0):
                raise JpegError(f"scan of spectral range {ss}..{se}, approximation {ahl:#x}: not sequential")
            segs, i = _segments(data, i)
            _decode_scan(frame, comps, segs, restart)
            scans += 1
        elif m == 0xDC:
            raise JpegError("DNL marker: a frame of unknown height is not supported")
        # APPn, COM and other markers carry nothing the pixels need
    if frame is None or scans == 0:
        raise JpegError("no frame or no scan in the file")
    for c in frame.comps:
        c["q"] = qt[c["tq"]]
    return frame


# jidctint.c's fixed-point constants, CONST_BITS = 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270, "0_899976223": 7373,
      "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v: list[torch.Tensor], descale: int) -> list[torch.Tensor]:
    """jidctint.c's 1-D pass on the eight inputs v[0..7] (int64), each
    output descaled by ``descale`` bits."""
    F = _F
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * F["0_541196100"]
    tmp2 = z1 + z3 * -F["1_847759065"]
    tmp3 = z1 + z2 * F["0_765366865"]
    tmp0 = (v[0] + v[4]) << _CONST_BITS
    tmp1 = (v[0] - v[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F["1_175875602"]
    t0, t1, t2, t3 = t0 * F["0_298631336"], t1 * F["2_053119869"], t2 * F["3_072711026"], t3 * F["1_501321110"]
    z1, z2 = z1 * -F["0_899976223"], z2 * -F["2_562915447"]
    z3, z4 = z3 * -F["1_961570560"] + z5, z4 * -F["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(x, descale) for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_table(device) -> torch.Tensor:
    """jdmaster.c's post-IDCT range limit, indexed by the output & 1023."""
    i = torch.arange(1024, device=device)
    return torch.where(i < 128, i + 128, torch.where(i < 512, 255, torch.where(i < 896, 0, i - 896)))


def idct_islow(coef: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, 64) zig-zag quantised coefficients and (64,) zig-zag quantiser ->
    (n, 8, 8) samples 0..255 (int64): jidctint.c ``jpeg_idct_islow``."""
    zz = torch.as_tensor(_ZIGZAG, device=coef.device)
    nat = torch.zeros_like(coef).index_copy_(1, zz, coef * q).view(-1, 8, 8)
    cols = _idct_1d([nat[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)  # pass 1: columns
    ws = torch.stack(cols, dim=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)  # pass 2: rows
    out = torch.stack(rows, dim=2)
    return _idct_table(coef.device)[out & 1023]


def upsample_h2v2_fancy(p: torch.Tensor) -> torch.Tensor:
    """(h, w) -> (2h, 2w): jdsample.c ``h2v2_fancy_upsample``, 3/4 of the
    nearer and 1/4 of the further sample in each dimension, edges
    replicated, biased 8 and 7 alternately."""
    up = torch.cat([p[:1], p[:-1]], 0)
    down = torch.cat([p[1:], p[-1:]], 0)
    cs = torch.stack([3 * p + up, 3 * p + down], dim=1).reshape(2 * p.shape[0], p.shape[1])  # column sums
    left = torch.cat([cs[:, :1], cs[:, :-1]], 1)
    right = torch.cat([cs[:, 1:], cs[:, -1:]], 1)
    return torch.stack([(3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4], dim=2).reshape(cs.shape[0], -1)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ``ycc_rgb_convert`` with its fixed-point tables (16 scale
    bits): (H, W) int64 planes -> (H, W, 3) uint8."""
    def fix(x):
        return int(x * (1 << 16) + 0.5)

    half = 1 << 15
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * x_cr + half) >> 16)
    g = y + ((-fix(0.34414) * x_cb + half - fix(0.71414) * x_cr) >> 16)
    b = y + ((fix(1.77200) * x_cb + half) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(torch.uint8)


def decode_jpeg(data: bytes, device=None) -> torch.Tensor:
    """The file's bytes -> (H, W, 3) uint8 RGB on ``device`` (the CPU by
    default); a greyscale file's one plane is repeated."""
    frame = parse_jpeg(data)
    device = torch.device(device or "cpu")
    planes = []
    for c in frame.comps:
        coef = torch.from_numpy(c["coef"]).to(device)
        q = torch.from_numpy(c["q"]).to(device)
        blocks = idct_islow(coef, q).view(c["bh"], c["bw"], 8, 8).permute(0, 2, 1, 3)
        plane = blocks.reshape(c["bh"] * 8, c["bw"] * 8)[:c["hgt"], :c["w"]]
        if (c["h"], c["v"]) != (frame.hmax, frame.vmax):
            plane = upsample_h2v2_fancy(plane)
        planes.append(plane[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0].to(torch.uint8)[..., None].expand(-1, -1, 3).contiguous()
    return ycc_to_rgb(*planes)


def read_jpeg(path: str | Path, device=None) -> torch.Tensor:
    """:func:`decode_jpeg` of a file."""
    return decode_jpeg(Path(path).read_bytes(), device)

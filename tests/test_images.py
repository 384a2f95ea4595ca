"""utils/images.py's PNG and GIF writers, read back by independent decoders
written from the file formats' specifications."""

import struct
import zlib

import numpy as np
import pytest

from deepfluids_tpu.utils import images


def _read_png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body)
        chunks.append((tag, body))
        pos += 12 + n
    assert [t for t, _ in chunks][0] == b"IHDR" and chunks[-1][0] == b"IEND"
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, ctype) == (8, 2)
    raw = zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()              # filter type None
    return rows[:, 1:].reshape(h, w, 3)


def _lzw_decode(data, min_size):
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    size, table, prev = min_size + 1, None, None
    val, pos, out = int.from_bytes(data, "little"), 0, bytearray()
    while pos + size <= 8 * len(data):
        code = (val >> pos) & ((1 << size) - 1)
        pos += size
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            size, prev = min_size + 1, None
            continue
        if code == eoi:
            break
        entry = table[code] if code < len(table) else prev + prev[:1]
        out += entry
        if prev is not None:
            table.append(prev + entry[:1])
            if len(table) == 1 << size and size < 12:
                size += 1
        prev = entry
    return bytes(out)


def _read_gif(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:6] == b"GIF89a"
    w, h, flags, _, _ = struct.unpack("<HHBBB", data[6:13])
    assert flags & 0x80                          # global colour table
    ncol = 2 << (flags & 7)
    palette = np.frombuffer(data[13:13 + 3 * ncol], np.uint8).reshape(-1, 3)
    pos, frames, delays = 13 + 3 * ncol, [], []

    def blocks(pos):
        out = bytearray()
        while data[pos]:
            out += data[pos + 1:pos + 1 + data[pos]]
            pos += 1 + data[pos]
        return bytes(out), pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:                    # extension
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                delays.append(struct.unpack("<H", body[1:3])[0])
        else:
            assert data[pos] == 0x2C             # image descriptor
            x, y, fw, fh, _ = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            assert (x, y, fw, fh) == (0, 0, w, h)
            min_size = data[pos + 10]
            body, pos = blocks(pos + 11)
            idx = np.frombuffer(_lzw_decode(body, min_size), np.uint8)
            frames.append(palette[idx.reshape(h, w)])
    return frames, delays


class TestWriters:
    def test_png_round_trip(self, tmp_path):
        rgb = np.random.default_rng(0).integers(0, 256, (13, 7, 3), np.uint8)
        path = images.write_png(str(tmp_path / "a.png"), rgb)
        np.testing.assert_array_equal(_read_png(path), rgb)

    @pytest.mark.parametrize("shape", [(5, 4), (40, 33)])
    def test_gif_round_trip(self, tmp_path, shape):
        rng = np.random.default_rng(1)
        frames = [rng.integers(0, 256, shape + (3,), np.uint8)
                  for _ in range(3)]
        path = images.write_gif(str(tmp_path / "a.gif"), frames, fps=20)
        got, delays = _read_gif(path)
        assert len(got) == 3 and delays == [5, 5, 5]
        for g, f in zip(got, frames):
            # Each channel lands in the middle of its 3-3-2-bit bin.
            assert np.abs(g.astype(int) - f).max() <= 32
            np.testing.assert_array_equal(
                g, images._GIF_PALETTE[images._gif_quantize(f)])

    def test_field_writers_decode(self, tmp_path):
        f = np.random.default_rng(2).normal(size=(16, 12, 2))
        png = _read_png(images.save_field_image(str(tmp_path / "f.png"), f))
        assert png.shape == (16, 12, 3)
        frames, _ = _read_gif(images.save_gif(str(tmp_path / "f.gif"),
                                              [f, 0.5 * f]))
        assert len(frames) == 2 and frames[0].shape == (16, 12, 3)

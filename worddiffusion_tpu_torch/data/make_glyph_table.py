"""Build the synthetic renderer's glyph table, and the renders that check it.

    python -m worddiffusion_tpu_torch.data.make_glyph_table

Needs Pillow (with raqm, as the reference renders were drawn) and
DejaVuSans; nothing else of the port does. It draws every character of the
port's alphabets, PHOS tables and word lists with PIL's
``ImageFont.truetype(DejaVuSans, 18)`` as the JAX ``render_word`` does and
writes ``data/glyphs_dejavusans18.npz``: each token's bitmap (characters,
then the ligatures the font's shaping substitutes) with its placement,
advances and pair kerning in 1/64 pixel as ``ImageFont.getlength`` reports
them, and the Pillow, FreeType and layout-engine versions. It then holds
``synthetic.draw_text`` against PIL's own ``ImageDraw.text`` on the three
word lists and on seeded random strings, and writes the counts into the
file. ``data/render_check.npz`` holds renders of ``pil_render_word`` (a
copy of the JAX ``render_word``) for ``chip_smoke.py`` to hold the
PIL-free renderer against where there is no PIL: a few bitmaps, and the
SHA-256 of many more.
"""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from . import alphabets, synthetic

FONT_CANDIDATES = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/TTF/DejaVuSans.ttf",
)
CHECK_FILE = os.path.join(os.path.dirname(__file__), "render_check.npz")
WORD_LISTS = synthetic.WORDS_200 + synthetic.WORDS_NOR + synthetic.WORDS_CVL
# (height, width, jitter, styled) of the checked renders
CHECK_SETTINGS = ((64, 256, True, True), (64, 256, True, False), (64, 256, False, False),
                  (50, 250, True, True), (50, 250, False, True), (16, 16, False, False))


def charset() -> list[str]:
    chars: set[str] = set()
    for name in dir(alphabets):
        value = getattr(alphabets, name)
        if name.isupper() and isinstance(value, str):
            chars |= set(value)
    for rows in alphabets.PHOS_SHAPE_TABLES.values():
        chars |= set(rows)
    for w in WORD_LISTS:
        chars |= set(w)
    return sorted(chars - {"\n"})


def load_font():
    from PIL import ImageFont

    for path in FONT_CANDIDATES:
        try:
            return ImageFont.truetype(path, 18), path
        except OSError:
            continue
    raise SystemExit("DejaVuSans.ttf not found; the glyph table is drawn from it")


def pil_draw_text(font, text: str, canvas_w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    im = Image.new("L", (canvas_w, 36), 255)
    ImageDraw.Draw(im).text((4, 4), text, fill=0, font=font)
    return np.asarray(im)


def pil_render_word(font, word: str, height: int = 64, width: int = 256, seed: int = 0,
                    jitter: bool = True, style: dict | None = None) -> np.ndarray:
    """Copy of ``worddiffusion_tpu/data/synthetic.py::render_word`` with the
    font passed in: the renders the PIL-free renderer is held against."""
    from PIL import Image, ImageDraw, ImageFilter

    rng = np.random.default_rng(synthetic.stable_seed(f"{word}|{seed}"))
    scratch = Image.new("L", (max(14 * len(word) + 16, 48), 36), 255)
    draw = ImageDraw.Draw(scratch)
    draw.text((4, 4), word, fill=0, font=font)
    arr = np.asarray(scratch)
    cols = np.where((arr < 128).any(axis=0))[0]
    rows = np.where((arr < 128).any(axis=1))[0]
    if len(cols) and len(rows):
        scratch = scratch.crop((cols[0], rows[0], cols[-1] + 1, rows[-1] + 1))
    if style is not None:
        h_frac = style["h_frac"] + (0.04 * (rng.random() - 0.5) if jitter else 0.0)
        target_h = int(height * h_frac)
    elif jitter:
        target_h = int(height * (0.45 + 0.25 * rng.random()))
    else:
        target_h = max(2, height * 3 // 4)
    target_h = max(2, min(height, target_h))
    scale = target_h / scratch.size[1]
    margin = min(8, max(0, width - 4))
    new_w = min(max(width - margin, 2), max(2, int(scratch.size[0] * scale)))
    word_img = scratch.resize((new_w, target_h), Image.BILINEAR)
    if style is not None and style.get("thickness"):
        word_img = word_img.filter(
            ImageFilter.MinFilter(3) if style["thickness"] == 1 else ImageFilter.MaxFilter(3))
    if jitter or style is not None:
        if style is not None:
            shear = style["shear"] + (0.06 * (rng.random() - 0.5) if jitter else 0.0)
        else:
            shear = (rng.random() - 0.5) * 0.4
        word_img = word_img.transform(
            word_img.size, Image.AFFINE, (1, shear, 0, 0, 1, 0), fillcolor=255)
    canvas = Image.new("L", (width, height), 255)
    max_x = max(1, width - new_w)
    x = int(rng.integers(0, max(1, max_x // 4))) if jitter else (width - new_w) // 2
    y = (height - target_h) // 2 + (int(rng.integers(-4, 5)) if jitter else 0)
    if style is not None:
        y += style["y_off"]
    y = max(0, min(height - target_h, y))
    canvas.paste(word_img, (x, y))
    out = np.asarray(canvas, dtype=np.float32)
    if jitter:
        sigma = style["noise"] if style is not None else 6.0
        out = out + rng.normal(0, sigma, out.shape)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return np.stack([out, out, out], axis=-1)


def _glyph(font, token: str):
    """A token drawn alone at (4, 4): its coverage bitmap, left column
    relative to the pen's pixel, top row relative to the origin."""
    cov = 255 - pil_draw_text(font, token, 96).astype(np.int32)
    ys, xs = np.nonzero(cov)
    if not len(xs):
        return np.zeros((0, 0), np.uint8), 0, 0
    bmp = cov[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1].astype(np.uint8)
    return bmp, int(xs.min()) - 4, int(ys.min()) - 4


def _table(font, tokens: list[str]) -> dict:
    glyphs = [_glyph(font, t) for t in tokens]
    sizes = [g[0].size for g in glyphs]
    offset = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    table = {
        "tokens": np.array(tokens),
        "advance": np.array([round(font.getlength(t) * 64) for t in tokens], np.int32),
        "kern": np.zeros((len(tokens), len(tokens)), np.int16),
        "bitmaps": np.concatenate([g[0].ravel() for g in glyphs]).astype(np.uint8),
        "offset": offset,
        "shape": np.array([g[0].shape for g in glyphs], np.int32).reshape(-1, 2),
        "dx": np.array([g[1] for g in glyphs], np.int32),
        "dy": np.array([g[2] for g in glyphs], np.int32),
    }
    return table


def _loaded(table: dict) -> dict:
    """The table as ``synthetic.glyph_table`` returns it, without a file."""
    import io

    buf = io.BytesIO()
    np.savez(buf, **table)
    buf.seek(0)
    return synthetic.read_glyph_table(buf)


def _kern(font, table: dict) -> None:
    """Pair kerning of every two tokens that shape as those two tokens."""
    t = _loaded(table)
    tokens = [str(s) for s in table["tokens"]]
    width = {s: font.getlength(s) for s in tokens}
    for i, a in enumerate(tokens):
        for j, b in enumerate(tokens):
            if synthetic.shape_text(a + b, t) == [i, j]:
                table["kern"][i, j] = round((font.getlength(a + b) - width[a] - width[b]) * 64)


def _mismatches(font, table: dict, texts) -> list[str]:
    t = _loaded(table)
    return [s for s in texts
            if not np.array_equal(synthetic.draw_text(s, max(14 * len(s) + 16, 48), t),
                                  pil_draw_text(font, s, max(14 * len(s) + 16, 48)))]


def build_table(font, chars: list[str]) -> dict:
    """Characters first; a pair (then a ligature and a character) that the
    table cannot draw as PIL does becomes a ligature token, until none is
    left."""
    ligatures: list[str] = []
    candidates = [a + b for a in chars for b in chars]
    while True:
        table = _table(font, chars + ligatures)
        _kern(font, table)
        new = [s for s in _mismatches(font, table, candidates) if s not in ligatures]
        if not new:
            return table
        ligatures += new
        candidates = [lig + c for lig in new for c in chars]


def render_settings():
    """(setting index, word index, word, height, width, jitter, style) of
    every checked render."""
    for si, (h, w, jitter, styled) in enumerate(CHECK_SETTINGS):
        for wi, word in enumerate(WORD_LISTS):
            style = synthetic.writer_style(str(wi % 7)) if styled else None
            yield si, wi, word, h, w, jitter, style


def check_renders(render) -> dict:
    """The renders ``chip_smoke.py`` holds the PIL-free renderer against:
    per setting, the SHA-256 of the grey planes of every word of the three
    lists in ``render_settings`` order, and, where the setting has no
    noise, one word's bitmap."""
    out: dict = {}
    digests = [hashlib.sha256() for _ in CHECK_SETTINGS]
    for si, wi, word, h, w, jitter, style in render_settings():
        img = render(word, h, w, seed=wi, jitter=jitter, style=style)[..., 0]
        digests[si].update(img.tobytes())
        if wi == 11 * si + 7 and not jitter:
            out[f"bitmap_{si}"] = img
            out[f"bitmap_{si}_word"] = np.array(word)
    out["sha256"] = np.array([d.hexdigest() for d in digests])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=synthetic.GLYPH_TABLE)
    p.add_argument("--check_out", default=CHECK_FILE)
    p.add_argument("--random_strings", type=int, default=3000)
    args = p.parse_args(argv)
    import PIL
    from PIL import features

    font, path = load_font()
    chars = charset()
    table = build_table(font, chars)
    rng = np.random.default_rng(0)
    randoms = ["".join(rng.choice(chars, rng.integers(1, 13))) for _ in range(args.random_strings)]
    texts = WORD_LISTS + randoms
    bad = _mismatches(font, table, texts)
    table.update(
        font=np.array(os.path.basename(path)), size=np.int32(18),
        pillow_version=np.array(PIL.__version__),
        freetype_version=np.array(features.version("freetype2") or ""),
        layout_engine=np.array("raqm " + (features.version("raqm") or "")
                               if font.layout_engine == 1 else "basic"),
        checked_texts=np.int32(len(texts)), checked_equal=np.int32(len(texts) - len(bad)))
    np.savez_compressed(args.out, **table)
    synthetic.glyph_table.cache_clear()  # later renders in this process read the new file
    print(f"{len(chars)} characters, ligatures {[s for s in table['tokens'] if len(s) > 1]}; "
          f"draw_text equals PIL on {len(texts) - len(bad)} of {len(texts)} texts "
          f"(first differing: {bad[:5]}) -> {args.out} ({os.path.getsize(args.out)} bytes)")
    check = check_renders(lambda *a, **k: pil_render_word(font, *a, **k))
    np.savez_compressed(args.check_out, **check)
    print(f"renders of {len(CHECK_SETTINGS)} settings x {len(WORD_LISTS)} words -> "
          f"{args.check_out} ({os.path.getsize(args.check_out)} bytes)")


if __name__ == "__main__":
    main()

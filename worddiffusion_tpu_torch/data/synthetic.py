# Copy of worddiffusion_tpu/data/synthetic.py, with render_word drawn from a glyph table instead of PIL.
"""Procedural handwritten-ish word image generator without PIL.

``stable_seed``, ``writer_style``, ``synthetic_corpus``, the word lists,
``corpus_lang`` and ``word_list`` are copies of the JAX module's.
``render_word`` draws the same images as the JAX ``render_word`` (PIL's
``ImageDraw.text`` with DejaVuSans at size 18, then PIL's crop, BILINEAR
resize, Min/MaxFilter, AFFINE shear and paste, then numpy noise) from a
glyph table built once from that font with PIL
(``data/make_glyph_table.py`` writes ``data/glyphs_dejavusans18.npz``),
and PIL's image operations written out in numpy. It makes the same
``default_rng`` draws in the same order, so sizes, offsets and noise are
exact. Text is shaped as Pillow's raqm layout shapes it: greedy ligature
substitution (``ff``, ``fi``, ``fl``, ``ffi``, ``ffl``), advances and pair
kerning in 1/64 pixel, each glyph placed at its pen position rounded to
the pixel and composited onto the coverage mask with the "over" rule. A
character that is not in the table raises.
"""

from __future__ import annotations

import functools
import os
import zlib

import numpy as np

from ..utils.images import _resample_axis
from .gt import Sample

GLYPH_TABLE = os.path.join(os.path.dirname(__file__), "glyphs_dejavusans18.npz")
_SCRATCH_H = 36  # the JAX renderer's scratch canvas height; text drawn at (4, 4)
_ORIGIN = 4


def stable_seed(name: str) -> int:
    """Deterministic per-name render seed. ``hash(str)`` is randomised
    per process (PYTHONHASHSEED), which would make the latent cache,
    the trainer, and the eval harness each see DIFFERENT pixels for the
    same sample — use this everywhere a sample name seeds a render."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def writer_style(writer: str) -> dict:
    """Deterministic per-writer rendering style (slant, size, ink noise,
    baseline). Gives synthetic corpora a LEARNABLE writer identity — the
    reference's writer conditioning / style-encoder training assume
    writers differ consistently (``feature_extractor.py``); plain
    per-image jitter has no writer signal."""
    rng = np.random.default_rng(stable_seed(f"writer-style|{writer}"))
    return {
        "shear": float((rng.random() - 0.5) * 0.7),
        "h_frac": float(0.45 + 0.3 * rng.random()),
        "noise": float(2.0 + 8.0 * rng.random()),
        "y_off": int(rng.integers(-5, 6)),
        "thickness": int(rng.integers(0, 3)),  # 0 none, 1 dilate, 2 erode
    }


def read_glyph_table(file) -> dict:
    """A glyph table (a path or file object): ``tokens`` (characters, then
    ligatures), ``advance`` [T] and ``kern`` [T, T] in 1/64 pixel, each
    token's bitmap (coverage 0..255, ``shape`` [T, 2], flattened at
    ``offset`` [T] in ``bitmaps``) with its left column relative to the
    pen's pixel (``dx``) and its top row relative to the text origin
    (``dy``)."""
    with np.load(file, allow_pickle=False) as z:
        t = {k: z[k] for k in z.files}
    tokens = [str(s) for s in t["tokens"]]
    t["index"] = {s: i for i, s in enumerate(tokens)}
    t["ligatures"] = sorted((s for s in tokens if len(s) > 1), key=len, reverse=True)
    t["glyphs"] = [t["bitmaps"][o : o + h * w].reshape(h, w).astype(np.int32)
                   for o, (h, w) in zip(t["offset"], t["shape"])]
    return t


@functools.cache
def glyph_table() -> dict:
    """The committed glyph table (``GLYPH_TABLE``), read once."""
    return read_glyph_table(GLYPH_TABLE)


def shape_text(word: str, table: dict | None = None) -> list[int]:
    """``word`` -> token indices: at each position the longest ligature that
    starts there, else the character. A character outside the table
    raises."""
    t = table or glyph_table()
    out, i = [], 0
    while i < len(word):
        lig = next((s for s in t["ligatures"] if word.startswith(s, i)), None)
        tok = lig or word[i]
        if tok not in t["index"]:
            raise ValueError(f"render_word: {word[i]!r} (in {word!r}) is not in the glyph table "
                             f"{os.path.basename(GLYPH_TABLE)}; regenerate it with the "
                             "character (data/make_glyph_table.py)")
        out.append(t["index"][tok])
        i += len(tok)
    return out


def draw_text(word: str, canvas_w: int, table: dict | None = None) -> np.ndarray:
    """PIL's ``ImageDraw.text((4, 4), word, fill=0)`` on a white "L" canvas
    [36, canvas_w] -> uint8: glyphs at their pen positions (rounded half
    up to the pixel), each composited onto the coverage mask as ``m + g -
    round(m * g / 255)``, clipped to the canvas; the ink is 255 - mask."""
    t = table or glyph_table()
    toks = shape_text(word, t)
    mask = np.zeros((_SCRATCH_H, canvas_w), np.int32)
    pen = _ORIGIN * 64
    for k, tok in enumerate(toks):
        g = t["glyphs"][tok]
        x0, y0 = ((pen + 32) >> 6) + int(t["dx"][tok]), _ORIGIN + int(t["dy"][tok])
        gx0, gy0 = max(0, -x0), max(0, -y0)
        x1, y1 = min(canvas_w, x0 + g.shape[1]), min(_SCRATCH_H, y0 + g.shape[0])
        if x1 > x0 + gx0 and y1 > y0 + gy0:
            src = g[gy0 : gy0 + y1 - y0 - gy0, gx0 : gx0 + x1 - x0 - gx0]
            dst = mask[y0 + gy0 : y1, x0 + gx0 : x1]
            dst += src - (dst * src + 127) // 255
        if k + 1 < len(toks):
            pen += int(t["advance"][tok]) + int(t["kern"][tok, toks[k + 1]])
    return (255 - mask).astype(np.uint8)


def _rank3(img: np.ndarray, op) -> np.ndarray:
    """PIL's ``MinFilter(3)`` / ``MaxFilter(3)``: the image expanded by one
    pixel with its edges replicated, then the 3x3 min or max."""
    p = np.pad(img, 1, mode="edge")
    h, w = img.shape
    return op.reduce([p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)])


def _shear(img: np.ndarray, shear: float, fill: int = 255) -> np.ndarray:
    """PIL's ``transform(size, AFFINE, (1, shear, 0, 0, 1, 0), fillcolor=fill)``
    with its default NEAREST resampling (``Geometry.c::affine_fixed``): 16.16
    fixed point, the output pixel (x, y) reads input column
    ``(FIX(0.5 + shear/2) + y*FIX(shear) + x*FIX(1)) >> 16`` of row y, where
    ``FIX(v) = floor(v * 65536 + 0.5)``; columns outside the image take
    ``fill``."""
    h, w = img.shape

    def fix(v):
        return int(np.floor(v * 65536.0 + 0.5))

    a0, a1, a2 = fix(1.0), fix(shear), fix(0.0 + 1.0 * 0.5 + shear * 0.5)
    xx = a2 + np.arange(h, dtype=np.int64)[:, None] * a1 + np.arange(w, dtype=np.int64)[None] * a0
    xin = xx >> 16
    inside = (xin >= 0) & (xin < w)
    rows = np.arange(h)[:, None].repeat(w, axis=1)
    return np.where(inside, img[rows, np.clip(xin, 0, w - 1)], fill).astype(np.uint8)


def _resize(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """PIL's ``resize((new_w, new_h), BILINEAR)`` of an "L" image: the
    horizontal pass where the width changes, then the vertical one."""
    a = img[:, :, None]
    if new_w != a.shape[1]:
        a = _resample_axis(a, new_w, axis=1)
    if new_h != a.shape[0]:
        a = _resample_axis(a, new_h, axis=0)
    return a[:, :, 0]


def render_word(
    word: str,
    height: int = 64,
    width: int = 256,
    seed: int = 0,
    jitter: bool = True,
    style: dict | None = None,
) -> np.ndarray:
    """-> uint8 [height, width, 3], black ink on white. ``style`` (from
    :func:`writer_style`) pins the writer-consistent parameters; per-image
    jitter then varies around them."""
    rng = np.random.default_rng(stable_seed(f"{word}|{seed}"))
    # render big, then scale down to the target height
    scratch = draw_text(word, max(14 * len(word) + 16, 48))
    cols = np.where((scratch < 128).any(axis=0))[0]
    rows = np.where((scratch < 128).any(axis=1))[0]
    if len(cols) and len(rows):
        scratch = scratch[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]
    if style is not None:
        h_frac = style["h_frac"] + (0.04 * (rng.random() - 0.5) if jitter else 0.0)
        target_h = int(height * h_frac)
    elif jitter:
        target_h = int(height * (0.45 + 0.25 * rng.random()))
    else:
        target_h = max(2, height * 3 // 4)
    target_h = max(2, min(height, target_h))
    scale = target_h / scratch.shape[0]
    margin = min(8, max(0, width - 4))  # tiny canvases (glyph crops) keep >0 width
    new_w = min(max(width - margin, 2), max(2, int(scratch.shape[1] * scale)))
    word_img = _resize(scratch, new_w, target_h)

    if style is not None and style.get("thickness"):
        word_img = _rank3(word_img, np.minimum if style["thickness"] == 1 else np.maximum)
    if jitter or style is not None:
        if style is not None:
            shear = style["shear"] + (0.06 * (rng.random() - 0.5) if jitter else 0.0)
        else:
            shear = (rng.random() - 0.5) * 0.4
        word_img = _shear(word_img, shear)

    canvas = np.full((height, width), 255, np.uint8)
    max_x = max(1, width - new_w)
    x = int(rng.integers(0, max(1, max_x // 4))) if jitter else (width - new_w) // 2
    y = (height - target_h) // 2 + (int(rng.integers(-4, 5)) if jitter else 0)
    if style is not None:
        y += style["y_off"]
    y = max(0, min(height - target_h, y))
    canvas[y : y + target_h, x : x + new_w] = word_img[: height - y, : width - x]

    out = canvas.astype(np.float32)
    if jitter:
        sigma = style["noise"] if style is not None else 6.0
        out = out + rng.normal(0, sigma, out.shape)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return np.stack([out, out, out], axis=-1)


def synthetic_corpus(
    words: list[str] | None = None,
    writers: int = 8,
    samples_per_word: int = 4,
) -> list[Sample]:
    """A small gt-like corpus for tests and benches."""
    words = words or [
        "the", "of", "and", "text", "getting", "prop", "hand", "writing",
        "word", "diffusion",
    ]
    out = []
    k = 0
    for w in words:
        for j in range(samples_per_word):
            out.append(Sample(image=f"syn-{k:05d}.png", writer=str(k % writers), word=w))
            k += 1
    return out


# A fixed 200-word english list (high-frequency words + the demo probe
# words), used to synthesise recognizer/VAE training corpora with a
# realistic word-length mix. Deterministic: tests and artifacts cite
# indices into it.
WORDS_200 = [
    "the", "of", "and", "text", "getting", "prop", "hand", "writing",
    "word", "diffusion",
    "a", "to", "in", "is", "you", "that", "it", "he", "was", "for",
    "on", "are", "as", "with", "his", "they", "at", "be", "this", "have",
    "from", "or", "one", "had", "by", "not", "but", "what", "all", "were",
    "we", "when", "your", "can", "said", "there", "use", "an", "each",
    "which", "she", "do", "how", "their", "if", "will", "up", "other",
    "about", "out", "many", "then", "them", "these", "so", "some", "her",
    "would", "make", "like", "him", "into", "time", "has", "look", "two",
    "more", "write", "go", "see", "number", "no", "way", "could", "people",
    "my", "than", "first", "water", "been", "call", "who", "oil", "its",
    "now", "find", "long", "down", "day", "did", "get", "come", "made",
    "may", "part", "over", "new", "sound", "take", "only", "little",
    "work", "know", "place", "year", "live", "me", "back", "give", "most",
    "very", "after", "thing", "our", "just", "name", "good", "sentence",
    "man", "think", "say", "great", "where", "help", "through", "much",
    "before", "line", "right", "too", "mean", "old", "any", "same", "tell",
    "boy", "follow", "came", "want", "show", "also", "around", "form",
    "three", "small", "set", "put", "end", "does", "another", "well",
    "large", "must", "big", "even", "such", "because", "turn", "here",
    "why", "ask", "went", "men", "read", "need", "land", "different",
    "home", "us", "move", "try", "kind", "picture", "again", "change",
    "off", "play", "spell", "air", "away", "animal", "house", "point",
    "page", "letter", "mother", "answer", "found", "study", "still",
    "learn", "should", "america", "world",

    # --- appended round 5 (indices 204+): more REAL words so
    # vocabularies past 204 stay natural language. word_list(n)
    # for n <= 204 is UNCHANGED (prefix semantics), so every
    # committed artifact (phosc_syn3/syn4 reproduction) is
    # unaffected; without these, n > 204 fell through to the
    # compound-word fallback ("thethe", "theof") and any unseen
    # eval split drawn there measured out-of-distribution junk
    # (seed-0 syn5 val ZSL 0.265 vs syn3 0.666 - round-5 log).
    "high", "every", "near", "add", "food", "between", "own", "below",
    "country", "plant", "last", "school", "father", "keep", "tree", "never",
    "start", "city", "earth", "eye", "light", "thought", "head", "under",
    "story", "saw", "left", "once", "paper", "together", "got", "group",
    "often", "run", "important", "until", "children", "side", "feet", "car",
    "mile", "night", "walk", "white", "sea", "began", "grow", "took",
    "river", "four", "carry", "state", "book", "hear", "stop", "without",
    "second", "later", "miss", "idea", "enough", "eat", "face", "watch",
    "far", "really", "almost", "let", "above", "girl", "sometimes", "mountain",
    "cut", "young", "talk", "soon", "list", "song", "being", "leave",
    "family", "body", "music", "color", "stand", "sun", "question", "fish",
    "area", "mark", "dog", "horse", "birds", "problem", "complete", "room",
    "knew", "since", "ever", "piece", "told", "usually", "friends", "easy",
    "heard", "order", "red", "door", "sure", "become", "top", "ship",
    "across", "today", "during", "short", "better", "best", "however", "low",
    "hours", "black", "products", "happened", "whole", "measure", "remember", "early",
    "waves", "reached",
]


# Common Norwegian words, biased towards ÆØÅ coverage so synthetic
# corpora exercise the extended alphabet (the reference's Norwegian
# datasets/alphabet: trainNorModifyCondition.py:60-64).
WORDS_NOR = [
    "og", "i", "jeg", "det", "at", "en", "et", "den", "til", "er",
    "som", "på", "de", "med", "han", "av", "ikke", "der", "så", "var",
    "meg", "seg", "men", "ett", "har", "om", "vi", "min", "mitt", "ha",
    "hadde", "hun", "nå", "over", "da", "ved", "fra", "du", "ut", "sin",
    "dem", "oss", "opp", "man", "kan", "hans", "hvor", "eller", "hva",
    "skal", "selv", "sjøl", "her", "alle", "vil", "bli", "ble", "blitt",
    "kunne", "inn", "når", "være", "kom", "noen", "noe", "ville", "dere",
    "deres", "kun", "ja", "etter", "ned", "skulle", "denne", "for",
    "deg", "si", "sine", "sitt", "mot", "å", "meget", "hvorfor", "går",
    "året", "ønske", "første", "væske", "løpe", "kjærlighet", "øy",
    "blå", "grønn", "høst", "vår", "sjø", "født", "død", "brød", "søt",
]


# CVL-style words biased towards the extended alphabet (digits and
# punctuation, ``regenerateFromtrainWord22CVL.py:73`` character set) so
# synthetic corpora exercise the classes plain-English lists never hit.
# Every character is in ``alphabets.CVL`` and none is '_' or leading/
# trailing whitespace (the OCR decode strips both).
WORDS_CVL = [
    "1850", "No.3", "don't", "it's", "well-known", "3rd", "Mr.", "etc.",
    "2+2=4", "why?", "yes!", "(sic)", "12:30", "co-op", "e.g.", "i.e.",
    "1,000", "half;", "A&B", "what?", "stop!", "one-way", "O'Brien",
    "4/5", "page#7", "x=9", "can't", "won't", "isn't", "we're",
    "you're", "they're", "I'm", "he's", "she's", "name:", "first,",
    "last.", "end;", "begin", "letter", "number", "write", "read",
    "hand", "word", "line", "page", "book", "text", "note", "date",
    "year", "1900", "1923", "42nd", "7th", "8vo", "pp.12", "vol.2",
    "fig.5", "sec.9", "ch.10", "art.3", "pt.1", "ed.2", "rev.",
    "op.cit.", "ibid.", "cf.", "viz.", "ca.1800", "b.1812", "d.1870",
    "anno", "circa", "about", "nearly", "almost", "quite", "rather",
    "very", "just", "only", "even", "still", "again", "often",
    "never", "always", "sometimes", "today", "morrow", "yester",
    "night", "day", "week", "month",
]

_WORD_LISTS = {
    "eng": WORDS_200, "gw": WORDS_200, "nor": WORDS_NOR, "cvl": WORDS_CVL,
}


def corpus_lang(data_cfg) -> str:
    """Which word list a preset's synthetic corpora should draw from.

    Keyed on the tokenizer alphabet first (the CVL preset keeps the
    'eng' PHOS tables — digits/punct have no PHOS rows — but its corpus
    must exercise the extended alphabet), falling back to the PHOS
    version (eng/gw/nor presets)."""
    if data_cfg.alphabet in _WORD_LISTS:
        return data_cfg.alphabet
    return data_cfg.phos_version


def word_list(n: int, lang: str = "eng") -> list[str]:
    """First ``n`` words of the fixed per-language list; past its end,
    deterministic compound words, guaranteed UNIQUE (duplicates would
    leak "unseen" words across a zero-shot train/test cut and inflate
    ZSL accuracy)."""
    base = _WORD_LISTS.get(lang, WORDS_200)
    if n <= len(base):
        return base[:n]
    out = list(base)
    seen = set(out)
    i = 0
    while len(out) < n:
        a = base[(i // len(base)) % len(base)]
        b = base[i % len(base)]
        w = a + b
        if i >= len(base) ** 2:  # compound space exhausted
            w = f"{w}{i}"
        i += 1
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out

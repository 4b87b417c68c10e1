"""The port's PIL-free synthetic renderer against the JAX ``render_word``
(PIL) on the same words, seeds and styles: every entry of the three word
lists, with and without a writer style, with and without jitter, at 64x256
and 50x250, and every character of the glyph table as a 16x16 glyph crop.
Tolerance: none, every image is bitwise equal (uint8 ``array_equal``)."""

import numpy as np
import pytest

from worddiffusion_tpu.data import synthetic as jsyn
from worddiffusion_tpu.data.dataset import char_glyphs as jchar_glyphs
from worddiffusion_tpu_torch.data import make_glyph_table as mgt
from worddiffusion_tpu_torch.data import synthetic as syn
from worddiffusion_tpu_torch.data.dataset import char_glyphs

WORDS = jsyn.WORDS_200 + jsyn.WORDS_NOR + jsyn.WORDS_CVL


@pytest.mark.parametrize("height,width", [(64, 256), (50, 250)])
@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("styled", [True, False])
def test_render_word_is_bitwise_the_jax_render(height, width, jitter, styled):
    differ = []
    for i, word in enumerate(WORDS):
        style = jsyn.writer_style(str(i % 11)) if styled else None
        ours = syn.render_word(word, height, width, seed=i, jitter=jitter, style=style)
        theirs = jsyn.render_word(word, height, width, seed=i, jitter=jitter, style=style)
        assert ours.dtype == np.uint8 and ours.shape == (height, width, 3)
        if not np.array_equal(ours, theirs):
            differ.append(word)
    assert not differ, f"{len(differ)} of {len(WORDS)} renders differ: {differ[:10]}"


def test_glyph_crops_are_bitwise_the_jax_crops():
    """Every character of the table as ``char_glyphs`` draws it (16x16, no
    jitter), and whole words of glyph slots."""
    chars = [str(t) for t in syn.glyph_table()["tokens"] if len(t) == 1]
    for c in chars:
        assert np.array_equal(syn.render_word(c, 16, 16, jitter=False),
                              jsyn.render_word(c, 16, 16, jitter=False)), repr(c)
    for word in ("hello", "Nørd", "don't", "affine"):
        assert np.array_equal(char_glyphs(word, 10, (16, 16)),
                              jchar_glyphs(word, 10, (16, 16)))


@pytest.mark.parametrize("word", ["", " ", "mmmmmmmmmmmmmm", "WWW", "office", "fff", "Å-ø"])
def test_edge_words_are_bitwise(word):
    """The empty word (nothing to crop), a blank, text wider than the scratch
    canvas (clipped), ligature runs and accents."""
    for jitter in (True, False):
        assert np.array_equal(syn.render_word(word, 64, 256, seed=3, jitter=jitter),
                              jsyn.render_word(word, 64, 256, seed=3, jitter=jitter))


def test_unknown_character_raises():
    with pytest.raises(ValueError, match="not in the glyph table"):
        syn.render_word("naïve€")


def test_table_records_its_sources_and_checks():
    import PIL

    t = syn.glyph_table()
    assert str(t["pillow_version"]) == PIL.__version__
    assert str(t["layout_engine"]).startswith("raqm")
    assert int(t["checked_equal"]) == int(t["checked_texts"]) >= 3000
    assert {str(s) for s in t["tokens"] if len(s) > 1} == {"ff", "fi", "fl", "ffi", "ffl"}


def test_committed_table_and_checks_are_what_the_generator_writes():
    """The generator, run here, rebuilds the committed table's glyphs and
    spacing, and its check renders match the committed ones."""
    font, _ = mgt.load_font()
    table = mgt.build_table(font, mgt.charset())
    committed = syn.glyph_table()
    for key in ("tokens", "advance", "kern", "bitmaps", "offset", "shape", "dx", "dy"):
        assert np.array_equal(table[key], committed[key]), key
    with np.load(mgt.CHECK_FILE) as z:
        check = {k: z[k] for k in z.files}
    ours = mgt.check_renders(syn.render_word)
    assert list(ours["sha256"]) == list(check["sha256"])
    for key in check:
        assert np.array_equal(ours[key], check[key]), key

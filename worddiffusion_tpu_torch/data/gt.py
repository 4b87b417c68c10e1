# Copy of worddiffusion_tpu/data/gt.py: the port imports nothing of the JAX package.
"""Ground-truth annotation parsers and the writer registry.

Supported formats (all observed under the reference ``gt/`` corpus):

- ``filter27``: ``writerId,imageId transcription`` per line, image file
  is ``imageId + '.png'`` (reference ``trainModifyCondition.py:985-990``;
  sample ``gt/gan.iam.test.gt copy.filter27``).
- ``charlevel``: same layout, with per-character crops named
  ``imageId_<k>_`` (``gt/charWordTrainIamAnnotation.txt``).
- ``cvl``: ``writer,imageId word`` where imageId embeds the word
  (``gt/cvlTrain.txt``).
- ``nor_csv``: headerless ``idx,imageFile,word``
  (``gt/norwegian/norwegian_train_data.csv``); the writer id is the
  leading index column.
- ``icpr_csv``: headered ``word_image,word,author``
  (``gt/train_metadata_norwegian_icpr.csv``).
- ``ocr_csv``: the HTR-prediction csv path (``--csvRead``,
  ``trainModifyCondition.py:938-1057``) with ``imageName`` /
  ``Actual`` / ``Predicted_All`` columns and an image->writer json.

All parsers produce a list of :class:`Sample` plus a
:class:`WriterRegistry` assigning dense writer indices in first-seen
order, exactly like the reference ``wr_dict`` construction
(``trainModifyCondition.py:1050-1056``).
"""

from __future__ import annotations

import csv as _csv
import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class Sample:
    image: str          # image file name (with extension)
    writer: str         # raw writer id string from the annotation
    word: str           # transcription


class WriterRegistry:
    """Writer-id string -> dense index, in first-seen order."""

    def __init__(self) -> None:
        self._index: dict[str, int] = {}

    def add(self, writer: str) -> int:
        if writer not in self._index:
            self._index[writer] = len(self._index)
        return self._index[writer]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, writer: str) -> int:
        return self._index[writer]

    def __contains__(self, writer: str) -> bool:
        return writer in self._index

    @property
    def mapping(self) -> dict[str, int]:
        return dict(self._index)

    def dump_json(self, path: str) -> None:
        """writers_dict_train.json compat (``trainModifyCondition.py:
        1061-1064``)."""
        with open(path, "w") as f:
            json.dump(self._index, f)

    @classmethod
    def from_json(cls, path: str) -> "WriterRegistry":
        reg = cls()
        with open(path) as f:
            data = json.load(f)
        # preserve stored indices (may not be contiguous-first-seen)
        reg._index = {k: int(v) for k, v in data.items()}
        return reg


def _parse_filter27(path: str, image_suffix: str = ".png") -> list[Sample]:
    samples = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            head, _, word = line.partition(" ")
            writer, _, image_id = head.partition(",")
            if not word or not image_id:
                continue  # malformed row (reference would raise mid-parse)
            samples.append(Sample(image=image_id + image_suffix, writer=writer, word=word))
    return samples


def _parse_nor_csv(path: str) -> list[Sample]:
    samples = []
    with open(path, encoding="utf-8") as f:
        for row in _csv.reader(f):
            if len(row) < 3:
                continue
            idx, image, word = row[0], row[1], row[2]
            samples.append(Sample(image=image, writer=idx, word=word))
    return samples


def _parse_icpr_csv(path: str) -> list[Sample]:
    samples = []
    with open(path, encoding="utf-8") as f:
        reader = _csv.DictReader(f)
        for row in reader:
            samples.append(
                Sample(image=row["word_image"], writer=row["author"], word=row["word"])
            )
    return samples


def _parse_ocr_csv(
    path: str,
    image_writer_json: str,
    transcription_plus_ocr: bool = False,
) -> list[Sample]:
    """HTR-prediction csv: label is the (padded) actual text, optionally
    concatenated with the OCR prediction (reference ``--trascriptionPlusOCR``
    path, ``trainModifyCondition.py:1000-1037``)."""
    with open(image_writer_json) as f:
        img_writer = json.load(f)
    samples = []
    with open(path, encoding="utf-8") as f:
        for row in _csv.DictReader(f):
            image = row["imageName"]
            actual = row.get("Actual") or "None"
            if len(actual) < 10:
                actual = actual.ljust(10)
            if transcription_plus_ocr:
                pred = row.get("Predicted_All") or ""
                if len(pred) < 32:
                    pred = pred.ljust(32)
                word = actual + pred
            else:
                word = actual
            if image not in img_writer:
                continue
            samples.append(Sample(image=image, writer=str(img_writer[image]), word=word))
    return samples


_PARSERS = {
    "filter27": _parse_filter27,
    "charlevel": _parse_filter27,  # same wire format, char-crop image ids
    "cvl": _parse_filter27,
    "nor_csv": _parse_nor_csv,
    "icpr_csv": _parse_icpr_csv,
}


def sniff_format(path: str) -> str:
    """Guess the annotation format from the extension and first line."""
    name = os.path.basename(path)
    if name.endswith(".filter27"):
        return "filter27"
    with open(path, encoding="utf-8") as f:
        first = f.readline().strip()
    if first.startswith("word_image,"):
        return "icpr_csv"
    if first.count(",") >= 2 and " " not in first:
        return "nor_csv"
    return "filter27"


def parse_gt(
    path: str,
    fmt: str | None = None,
    partial_load: float = 0.0,
    **kwargs,
) -> tuple[list[Sample], WriterRegistry]:
    """Parse an annotation file into samples + writer registry.

    ``partial_load`` in (0, 1] keeps only the leading fraction of rows,
    like the reference ``--partialLoad`` (``trainModifyCondition.py:
    966-983``).
    """
    fmt = fmt or sniff_format(path)
    if fmt == "ocr_csv":
        samples = _parse_ocr_csv(path, **kwargs)
    else:
        samples = _PARSERS[fmt](path, **kwargs)
    if partial_load:
        samples = samples[: int(len(samples) * partial_load)]
    registry = WriterRegistry()
    for s in samples:
        registry.add(s.writer)
    return samples, registry

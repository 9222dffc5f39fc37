"""A fixed-width bitmap font for a-z and 0-9, drawn in numpy.

The JAX package's synthetic datasets draw text with PIL's default font,
which Pillow 10 and later render with FreeType, anti-aliased; no numpy
code reproduces it, and the machine with the card has no PIL. The port
draws from this table instead. Its glyphs are about PIL's default glyphs
at that size (10 px): 5 px wide on a 6 px advance, digits and ascenders
8 rows tall from 2 rows below the text origin, the x-height 6 rows, the
baseline 9 rows below the origin, descenders 2 rows under it. Pixels are
set to the fill colour, with no anti-aliasing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

ADVANCE = 6          # px per character
TOP = 2              # rows from the text origin to the table's first row

# rows 0-1 ascenders and digit tops, 2-7 the x-height, 8-9 descenders
_ROWS = {
    "a": ".....|.....|.###.|....#|.####|#...#|#..##|.##.#|.....|.....",
    "b": "#....|#....|#.##.|##..#|#...#|#...#|##..#|#.##.|.....|.....",
    "c": ".....|.....|.###.|#...#|#....|#....|#...#|.###.|.....|.....",
    "d": "....#|....#|.##.#|#..##|#...#|#...#|#..##|.##.#|.....|.....",
    "e": ".....|.....|.###.|#...#|#####|#....|#...#|.###.|.....|.....",
    "f": "..##.|.#..#|.#...|####.|.#...|.#...|.#...|.#...|.....|.....",
    "g": ".....|.....|.####|#...#|#...#|#...#|.####|....#|#...#|.###.",
    "h": "#....|#....|#.##.|##..#|#...#|#...#|#...#|#...#|.....|.....",
    "i": "..#..|.....|.##..|..#..|..#..|..#..|..#..|.###.|.....|.....",
    "j": "...#.|.....|..##.|...#.|...#.|...#.|...#.|...#.|#..#.|.##..",
    "k": "#....|#....|#..#.|#.#..|##...|#.#..|#..#.|#...#|.....|.....",
    "l": ".##..|..#..|..#..|..#..|..#..|..#..|..#..|.###.|.....|.....",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#.#.#|#.#.#|#.#.#|.....|.....",
    "n": ".....|.....|#.##.|##..#|#...#|#...#|#...#|#...#|.....|.....",
    "o": ".....|.....|.###.|#...#|#...#|#...#|#...#|.###.|.....|.....",
    "p": ".....|.....|#.##.|##..#|#...#|#...#|##..#|#.##.|#....|#....",
    "q": ".....|.....|.##.#|#..##|#...#|#...#|#..##|.##.#|....#|....#",
    "r": ".....|.....|#.##.|##..#|#....|#....|#....|#....|.....|.....",
    "s": ".....|.....|.####|#....|.###.|....#|....#|####.|.....|.....",
    "t": ".#...|.#...|####.|.#...|.#...|.#...|.#..#|..##.|.....|.....",
    "u": ".....|.....|#...#|#...#|#...#|#...#|#..##|.##.#|.....|.....",
    "v": ".....|.....|#...#|#...#|#...#|.#.#.|.#.#.|..#..|.....|.....",
    "w": ".....|.....|#...#|#...#|#.#.#|#.#.#|#.#.#|.#.#.|.....|.....",
    "x": ".....|.....|#...#|.#.#.|..#..|..#..|.#.#.|#...#|.....|.....",
    "y": ".....|.....|#...#|#...#|#...#|#...#|.####|....#|#...#|.###.",
    "z": ".....|.....|#####|...#.|..#..|.#...|#....|#####|.....|.....",
    "0": ".###.|#...#|#..##|#.#.#|##..#|#...#|#...#|.###.|.....|.....",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|..#..|.###.|.....|.....",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#....|#####|.....|.....",
    "3": "#####|...#.|..#..|.###.|....#|....#|#...#|.###.|.....|.....",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.|...#.|.....|.....",
    "5": "#####|#....|####.|....#|....#|....#|#...#|.###.|.....|.....",
    "6": "..##.|.#...|#....|####.|#...#|#...#|#...#|.###.|.....|.....",
    "7": "#####|....#|...#.|..#..|.#...|.#...|.#...|.#...|.....|.....",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|#...#|.###.|.....|.....",
    "9": ".###.|#...#|#...#|#...#|.####|....#|...#.|.##..|.....|.....",
}
GLYPHS = {c: np.array([[ch == "#" for ch in row] for row in rows.split("|")])
          for c, rows in _ROWS.items()}
HEIGHT, WIDTH = GLYPHS["a"].shape


def text_mask(text: str) -> np.ndarray:
    """bool (HEIGHT, ADVANCE * len(text)) coverage of `text`, its top row
    TOP rows below the text origin."""
    out = np.zeros((HEIGHT, ADVANCE * len(text)), bool)
    for i, c in enumerate(text):
        try:
            out[:, ADVANCE * i:ADVANCE * i + WIDTH] = GLYPHS[c]
        except KeyError:
            raise ValueError(f"no glyph for {c!r} (a-z and 0-9 "
                             "only)") from None
    return out


def text_bbox(xy: Tuple[int, int], text: str) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom) of the pixels `draw_text` sets, right and
    bottom exclusive, as PIL's `ImageDraw.textbbox` reports its own."""
    m = text_mask(text)
    rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
    x, y = xy
    return (x + int(cols[0]), y + TOP + int(rows[0]), x + int(cols[-1]) + 1,
            y + TOP + int(rows[-1]) + 1)


def draw_text(img: np.ndarray, xy: Tuple[int, int], text: str,
              fill) -> None:
    """Set the pixels of `text` at `xy` = (x, y) in `img` (H, W) or (H, W,
    C) to `fill`, clipped to the image, in place."""
    m = text_mask(text)
    x, y = xy[0], xy[1] + TOP
    h, w = img.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + m.shape[0], h), min(x + m.shape[1], w)
    if y0 >= y1 or x0 >= x1:
        return
    sub = m[y0 - y:y1 - y, x0 - x:x1 - x]
    img[y0:y1, x0:x1][sub] = fill

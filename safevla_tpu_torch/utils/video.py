"""Copy of `safevla_tpu/utils/video.py` (plain numpy; imageio optional).

Episode video logging: frame annotation + mp4 writing.

Counterpart of reference utils/local_logging.py / visualization_utils.py /
data_generation_utils/mp4_utils.py: eval episodes render annotated frames
(action taken, action distribution bars, step/reward/cost readout) into an
mp4 (imageio when available, .npy fallback).
All drawing is plain numpy so there is no PIL/matplotlib dependency.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# Real 5x7 bitmap font for the HUD (the reference renders text with
# Arial.ttf via PIL, visualization_utils.py:231+; a classic 5x7 terminal
# font keeps this dependency-free while remaining actually readable).
_GLYPH_ART = {
    "0": ".###. #...# #..## #.#.# ##..# #...# .###.",
    "1": "..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.",
    "2": ".###. #...# ....# ...#. ..#.. .#... #####",
    "3": ".###. #...# ....# ..##. ....# #...# .###.",
    "4": "...#. ..##. .#.#. #..#. ##### ...#. ...#.",
    "5": "##### #.... ####. ....# ....# #...# .###.",
    "6": "..##. .#... #.... ####. #...# #...# .###.",
    "7": "##### ....# ...#. ..#.. .#... .#... .#...",
    "8": ".###. #...# #...# .###. #...# #...# .###.",
    "9": ".###. #...# #...# .#### ....# ...#. .##..",
    "a": "..... ..... .###. ....# .#### #...# .####",
    "b": "#.... #.... ####. #...# #...# #...# ####.",
    "c": "..... ..... .###. #.... #.... #...# .###.",
    "d": "....# ....# .#### #...# #...# #...# .####",
    "e": "..... ..... .###. #...# ##### #.... .###.",
    "f": "..##. .#..# .#... ###.. .#... .#... .#...",
    "g": "..... .#### #...# #...# .#### ....# .###.",
    "h": "#.... #.... ####. #...# #...# #...# #...#",
    "i": "..#.. ..... .##.. ..#.. ..#.. ..#.. .###.",
    "j": "...#. ..... ..##. ...#. ...#. #..#. .##..",
    "k": "#.... #.... #..#. #.#.. ##... #.#.. #..#.",
    "l": ".##.. ..#.. ..#.. ..#.. ..#.. ..#.. .###.",
    "m": "..... ..... ##.#. #.#.# #.#.# #.#.# #...#",
    "n": "..... ..... ####. #...# #...# #...# #...#",
    "o": "..... ..... .###. #...# #...# #...# .###.",
    "p": "..... ####. #...# #...# ####. #.... #....",
    "q": "..... .#### #...# #...# .#### ....# ....#",
    "r": "..... ..... #.##. ##..# #.... #.... #....",
    "s": "..... ..... .#### #.... .###. ....# ####.",
    "t": ".#... .#... ###.. .#... .#... .#..# ..##.",
    "u": "..... ..... #...# #...# #...# #..## .##.#",
    "v": "..... ..... #...# #...# #...# .#.#. ..#..",
    "w": "..... ..... #...# #.#.# #.#.# #.#.# .#.#.",
    "x": "..... ..... #...# .#.#. ..#.. .#.#. #...#",
    "y": "..... #...# #...# .#### ....# #...# .###.",
    "z": "..... ..... ##### ...#. ..#.. .#... #####",
    " ": "..... ..... ..... ..... ..... ..... .....",
    ".": "..... ..... ..... ..... ..... .##.. .##..",
    ":": "..... .##.. .##.. ..... .##.. .##.. .....",
    "-": "..... ..... ..... ##### ..... ..... .....",
    "/": "....# ...#. ...#. ..#.. .#... .#... #....",
    "+": "..... ..#.. ..#.. ##### ..#.. ..#.. .....",
}
_GLYPHS = {c: i for i, c in enumerate(_GLYPH_ART)}
_FONT = None


def _font() -> np.ndarray:
    """Lazy (n_glyphs, 7, 5) boolean bitmap decoded from the glyph art."""
    global _FONT
    if _FONT is None:
        _FONT = np.zeros((len(_GLYPH_ART), 7, 5), bool)
        for ch, art in _GLYPH_ART.items():
            rows = art.split()
            assert len(rows) == 7 and all(len(r) == 5 for r in rows), ch
            for r, row in enumerate(rows):
                for c, px in enumerate(row):
                    _FONT[_GLYPHS[ch], r, c] = px == "#"
    return _FONT


def draw_text(frame: np.ndarray, text: str, x: int, y: int, color=(255, 255, 0)):
    font = _font()
    for ch in text.lower():
        idx = _GLYPHS.get(ch)
        if idx is not None:
            mask = font[idx]
            h, w = mask.shape
            y2, x2 = min(y + h, frame.shape[0]), min(x + w, frame.shape[1])
            if y2 <= y or x2 <= x:  # glyph fully off-frame: stop drawing
                break
            sub = mask[: y2 - y, : x2 - x]
            frame[y:y2, x:x2][sub] = color
        x += 6
    return frame


def draw_action_bars(
    frame: np.ndarray,
    probs: Sequence[float],
    chosen: int,
    x: int = 4,
    y: int = 4,
    bar_h: int = 3,
    bar_w_max: int = 60,
):
    """Horizontal probability bars, chosen action highlighted
    (reference visualization_utils.py:231+)."""
    for i, p in enumerate(probs):
        yy = y + i * (bar_h + 1)
        if yy + bar_h >= frame.shape[0]:
            break
        w = max(1, int(p * bar_w_max))
        color = (0, 255, 0) if i == chosen else (200, 200, 200)
        frame[yy : yy + bar_h, x : x + w] = color
    return frame


def annotate_frame(
    frame: np.ndarray,
    step: int,
    action_name: str,
    probs: Optional[Sequence[float]] = None,
    chosen: Optional[int] = None,
    reward: Optional[float] = None,
    cost: Optional[float] = None,
) -> np.ndarray:
    frame = np.ascontiguousarray(frame).copy()
    if probs is not None and chosen is not None:
        draw_action_bars(frame, probs, chosen)
    hud = f"{step} {action_name}"
    if reward is not None:
        hud += f" r:{reward:.2f}"
    if cost is not None:
        hud += f" c:{cost:.0f}"
    draw_text(frame, hud, 4, frame.shape[0] - 10)
    return frame


def save_video(frames: List[np.ndarray], path: str, fps: int = 5) -> str:
    """mp4 via imageio if possible; .npy stack fallback."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:  # pragma: no cover - depends on imageio/ffmpeg
        import imageio.v3 as iio

        iio.imwrite(path, np.stack(frames), fps=fps, extension=".mp4")
        return path
    except Exception:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, np.stack(frames))
        return alt


def save_image(frame: np.ndarray, path: str) -> str:
    """png via imageio if possible; .npy fallback."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:  # pragma: no cover - depends on imageio
        import imageio.v3 as iio

        iio.imwrite(path, frame)
        return path
    except Exception:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, frame)
        return alt


class EpisodeVideoRecorder:
    """Collects annotated frames over an episode and writes one file."""

    def __init__(self, out_dir: str, fps: int = 5):
        self.out_dir = out_dir
        self.fps = fps
        self.frames: List[np.ndarray] = []

    def add(self, frame: np.ndarray, **annotate_kwargs):
        self.frames.append(annotate_frame(frame, **annotate_kwargs))

    def save(self, episode_id: str) -> Optional[str]:
        if not self.frames:
            return None
        safe = episode_id.replace("/", "_").replace("=", "-").replace(",", "_")
        path = os.path.join(self.out_dir, f"{safe}.mp4")
        out = save_video(self.frames, path, self.fps)
        self.frames = []
        return out

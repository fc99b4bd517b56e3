"""Format normalization + extension policy (ingest hygiene).

  - convert_to_jpeg: png/bmp/gif/tiff/webp -> JPEG q95; alpha composited
    onto WHITE; palette/exotic modes -> RGB
    (tool/Image format conversion.py:5-71 incl. :49-53 alpha handling).
  - delete_non_jpeg: remove every non-.jpg/.jpeg IMAGE file under a
    tree (tool/delete.py:18-34 matches against its image_extensions
    list, so .txt/.mp4 and other non-image files are untouched — same
    here), dry-run by default.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CONVERTIBLE = (".png", ".bmp", ".gif", ".tiff", ".tif", ".webp")


@dataclass
class ConvertReport:
    converted: List[Tuple[str, str]] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)
    errors: List[Tuple[str, str]] = field(default_factory=list)
    dry_run: bool = True


def convert_to_jpeg(
    root: str,
    quality: int = 95,
    remove_original: bool = True,
    dry_run: bool = True,
) -> ConvertReport:
    from PIL import Image

    report = ConvertReport(dry_run=dry_run)
    for dirpath, _d, files in os.walk(root):
        for fn in sorted(files):
            if not fn.lower().endswith(CONVERTIBLE):
                continue
            src = os.path.join(dirpath, fn)
            dst = os.path.splitext(src)[0] + ".jpg"
            if os.path.exists(dst):
                # a DISTINCT photo.jpg already sits next to photo.png —
                # converting would silently destroy it; skip + report
                # (the dry-run predicts the same outcome)
                report.errors.append(
                    (src, f"target exists, not overwriting: {dst}"))
                continue
            try:
                if not dry_run:
                    with Image.open(src) as img:
                        if img.mode in ("RGBA", "LA", "PA") or (
                            img.mode == "P" and "transparency" in img.info
                        ):
                            img = img.convert("RGBA")
                            bg = Image.new("RGB", img.size, (255, 255, 255))
                            bg.paste(img, mask=img.split()[-1])
                            img = bg
                        elif img.mode != "RGB":
                            img = img.convert("RGB")
                        img.save(dst, "JPEG", quality=quality)
                    if remove_original and os.path.abspath(src) != os.path.abspath(dst):
                        os.remove(src)
                report.converted.append((src, dst))
            except Exception as e:  # noqa: BLE001
                report.errors.append((src, repr(e)))
    return report


def delete_non_jpeg(
    root: str,
    keep: Sequence[str] = (".jpg", ".jpeg"),
    dry_run: bool = True,
) -> ConvertReport:
    report = ConvertReport(dry_run=dry_run)
    keep_l = tuple(k.lower() for k in keep)
    image_exts = (".png", ".bmp", ".gif", ".tiff", ".tif", ".webp",
                  ".jpg", ".jpeg")
    for dirpath, _d, files in os.walk(root):
        for fn in sorted(files):
            low = fn.lower()
            if low.endswith(image_exts) and not low.endswith(keep_l):
                p = os.path.join(dirpath, fn)
                try:
                    if not dry_run:
                        os.remove(p)
                    report.deleted.append(p)
                except OSError as e:
                    report.errors.append((p, repr(e)))
    return report

"""Caption routing / language tagging (the port's own copy of
``pea_diffusion_tpu/data/captions.py``; reference
utils/custom_dataset_sdxl.py:315-379).

Selects the caption field by source-dataset convention, strips characters
outside the allowed CJK+punctuation set, converts traditional->simplified
Chinese, and tags `zh_or_not` (1 = Chinese-native sample -> denoising loss;
0 = translated/EN parallel sample -> KD losses). `caption_en` is preserved
for the teacher.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

# Keep: CJK unified ideographs + ASCII/CJK punctuation + digits (the regex at
# utils/custom_dataset_sdxl.py:321)
_KEEP_RE = re.compile(r"[^一-龥,.!?:;，。！？：；“”1234567890]")

try:  # optional dependency; without it, the built-in table below
    import zhconv

    def to_simplified(text: str) -> str:
        return zhconv.convert(text, "zh-hans")
except ImportError:
    # Minimal built-in traditional->simplified map covering common characters;
    # identity for everything else (zip pairs defensively, no length assert).
    _TRAD = "萬與醜專業叢東絲丟兩嚴喪個豐臨為麗舉麼義烏樂喬習鄉書買亂爭於虧雲亞產畝親億僅從倉儀們價眾優會偉傳傷倆偽體餘俠偵側僑倫頭顏風飛馬鳥龍龜國圖圓團"
    _SIMP = "万与丑专业丛东丝丢两严丧个丰临为丽举么义乌乐乔习乡书买乱争于亏云亚产亩亲亿仅从仓仪们价众优会伟传伤俩伪体余侠侦侧侨伦头颜风飞马鸟龙龟国图圆团"
    _T2S = {ord(t): s for t, s in zip(_TRAD, _SIMP)}

    def to_simplified(text: str) -> str:
        return text.translate(_T2S)


def contains_chinese(text: str) -> bool:
    return any("一" <= ch <= "鿿" for ch in text)


def clean_chinese(text: str) -> str:
    return to_simplified(_KEEP_RE.sub("", text))


def route_caption(meta: Dict) -> Tuple[str, int, str]:
    """json metadata -> (prompt, zh_or_not, caption_en).

    Field priority mirrors the reference exactly: caption_ori (wukong) >
    caption_ori_zh (laion-zh/translated) > caption_ori_en (scraped) >
    caption_zh (machine-translated, zh_or_not=0) > empty."""
    for key in ("caption_ori", "caption_ori_zh", "caption_ori_en"):
        if key == "caption_ori_zh" and "caption_ori" in meta:
            continue  # reference guard (utils/custom_dataset_sdxl.py:336)
        if key in meta and contains_chinese(str(meta[key])):
            return clean_chinese(str(meta[key])), 1, str(meta.get("caption_en", ""))
    if "caption_zh" in meta:
        return str(meta["caption_zh"]), 0, str(meta.get("caption_en", ""))
    return "", 0, str(meta.get("caption_en", ""))


def passes_quality(meta: Dict, width: int, height: int, *,
                   min_area: int = 640 * 640, min_aesthetic: float = 6.0,
                   max_watermark: float = 0.5) -> bool:
    """Quality filter (utils/custom_dataset_sdxl.py:59-66): Chinese-native
    sources only need the area check; others also need aesthetic/watermark."""
    if "watermark" not in meta:
        return True
    if "caption_ori" in meta or "caption_ori_zh" in meta:
        return width * height >= min_area
    return (width * height >= min_area
            and meta.get("aesthetic_score", 0.0) >= min_aesthetic
            and meta.get("watermark", 1.0) <= max_watermark)

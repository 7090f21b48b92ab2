from .buckets import BUCKETS, BUCKET_PROBS, assign_bucket
from .captions import passes_quality, route_caption
from .multiplexer import BucketBatcher
from .pipeline import DevicePrefetcher, collate, make_train_iterator, prefetch_to_device
from .wds_reader import expand_urls, sample_stream, split_by_process

__all__ = [
    "BUCKETS", "BUCKET_PROBS", "assign_bucket", "route_caption",
    "passes_quality", "BucketBatcher", "collate", "make_train_iterator",
    "DevicePrefetcher", "prefetch_to_device", "expand_urls", "sample_stream",
    "split_by_process",
]

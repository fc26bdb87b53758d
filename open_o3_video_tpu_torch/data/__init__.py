"""Host-side data plane of the port: chat template, tokenizer, patchify,
video reading."""

from .video import fetch_video, fetch_video_fast, fetch_video_raw, smart_resize

# The errors that mean "this example's data is bad" (a missing or unreadable
# file, a bad field): the SFT loop skips such a batch and the eval harnesses
# record and skip such an item. Anything else (a missing reader, an error on
# the device) propagates.
DATA_ERRORS = (OSError, ValueError, KeyError)

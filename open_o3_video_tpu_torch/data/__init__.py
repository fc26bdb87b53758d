"""Host-side data plane of the port: chat template, tokenizer, patchify."""

# The errors that mean "this example's data is bad" (a missing or unreadable
# file, a bad field): the SFT loop skips such a batch and the eval harnesses
# record and skip such an item. Anything else (a missing reader, an error on
# the device) propagates.
DATA_ERRORS = (OSError, ValueError, KeyError)

"""Host-side data plane of the port: chat template, tokenizer, patchify."""

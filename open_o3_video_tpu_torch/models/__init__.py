"""Model families of the port (Qwen2.5-VL)."""

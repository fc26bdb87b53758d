"""Single-example grounded video QA on the PyTorch port: the sibling of
scripts/inference_example.py, driving open_o3_video_tpu_torch's engine.

Run: python scripts/inference_example_torch.py --model_path /path/to/checkpoint \
        --video example_video.mp4
     python scripts/inference_example_torch.py --tiny-demo   # no checkpoint, no video

Sampling mirrors the reference: temperature 0.7, top_p 0.001, repetition
penalty 1.05, max 2048 tokens, 16 frames. A video file is decoded with the
JAX package's host decoder (PIL/cv2; it imports no JAX); without --video the
frames are synthetic (16 frames of 252x336 from --seed). The checkpoint is
read with safetensors. The model runs on the card (--device cuda, the
default) in bf16 through the port's kernels; with --device cpu in float32
through their plain versions. Without a CUDA device it runs only when asked
for the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_pretrained(model_dir: str, device):
    """(params, cfg) from an HF Qwen2.5-VL directory of safetensors shards."""
    from safetensors import safe_open

    from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig, params as P

    cfg = Qwen25VLConfig.from_pretrained(model_dir)
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))

    def named():
        for shard in shards:
            with safe_open(os.path.join(model_dir, shard), framework="pt") as f:
                for key in f.keys():
                    yield key, f.get_tensor(key)

    return P.from_hf_state_dict(named(), cfg, device), cfg


def demo_config(dtype):
    """A small random model whose head dims (80 vision, 128 text) are the
    ones the CUDA kernels are built for, with the real special token ids."""
    from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig

    cfg = Qwen25VLConfig(dtype=dtype)
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, depth=2, hidden_size=160, intermediate_size=320,
                                   num_heads=2, fullatt_block_indexes=(1,), out_hidden_size=256),
        text=dataclasses.replace(cfg.text, hidden_size=256, intermediate_size=512,
                                 num_hidden_layers=2, num_attention_heads=2,
                                 num_key_value_heads=1),
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", default=None, help="HF checkpoint dir")
    parser.add_argument("--video", default=None, help="video file (default: synthetic frames)")
    parser.add_argument("--nframes", type=int, default=16)
    parser.add_argument("--max_tokens", type=int, default=2048)
    parser.add_argument("--kv_cache", choices=["bf16", "fp8"], default="bf16",
                        help="KV cache dtype: bf16, or fp8 = torch.float8_e4m3fn (half the "
                             "bytes; decode at 32768+ slots reads it as stored)")
    parser.add_argument("--tiny-demo", action="store_true",
                        help="run a small random-weight model (pipeline smoke test)")
    parser.add_argument("--greedy", action="store_true", help="temperature 0")
    parser.add_argument("--spec", action="store_true",
                        help="speculative decoding (not in the port yet)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, where the kernels' plain versions run")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--questions", nargs="+", default=[
        "What is the color of the bowling ball?",
        "What is the first scene about?",
    ])
    args = parser.parse_args()
    if args.spec:
        parser.error("--spec: the port has no speculative decoding yet")

    import numpy as np
    import torch

    from open_o3_video_tpu_torch.data.processor import (
        IMAGE_PAD, VIDEO_PAD, VISION_END, VISION_START, O3VideoProcessor,
    )
    from open_o3_video_tpu_torch.engine import InferenceEngine, Request, SamplingParams
    from open_o3_video_tpu_torch.grounding.prompts import SYSTEM_PROMPT
    from open_o3_video_tpu_torch.models.qwen25vl import params as P

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device here; pass --device cpu to run on the CPU")
    if args.tiny_demo:
        cfg = demo_config(torch.bfloat16 if device.type == "cuda" else torch.float32)
        params = P.init(cfg, args.seed, device)
        processor = O3VideoProcessor()
        max_tokens = min(args.max_tokens, 32)
    else:
        if not args.model_path:
            parser.error("--model_path required (or use --tiny-demo)")
        params, cfg = load_pretrained(args.model_path, device)
        processor = O3VideoProcessor.from_pretrained(args.model_path)
        max_tokens = args.max_tokens

    cache_dtype = torch.float8_e4m3fn if args.kv_cache == "fp8" else torch.bfloat16
    engine = InferenceEngine(params, cfg, cache_dtype=cache_dtype)
    sampling = SamplingParams(
        temperature=0.0 if args.greedy else 0.7, top_p=0.001,
        repetition_penalty=1.05, max_tokens=max_tokens, seed=args.seed,
    )
    system_message = SYSTEM_PROMPT["temporal-spatial free-form QA"]

    if args.video:
        from open_o3_video_tpu.data.video import process_vision_info

        video_msg = {"type": "video", "video": args.video, "nframes": args.nframes}
        _, video_inputs, video_kwargs = process_vision_info(
            [{"role": "user", "content": [video_msg]}], return_video_kwargs=True
        )
        frames, fps = video_inputs[0], video_kwargs["fps"][0]
    else:
        rng = np.random.default_rng(args.seed)
        frames = rng.integers(0, 256, size=(args.nframes, 3, 252, 336), dtype=np.uint8)
        fps = 2.0

    for question in args.questions:
        messages = [
            {"role": "system", "content": [{"type": "text", "text": system_message}]},
            {"role": "user", "content": [
                {"type": "video", "video": args.video or "synthetic", "nframes": args.nframes},
                {"type": "text", "text": question},
            ]},
        ]
        prompt = processor.apply_chat_template(messages, add_generation_prompt=True)
        frame_prompt = "".join(
            f"Frame {i + 1} at {round(i / fps, 1)} second: "
            f"{VISION_START}{IMAGE_PAD}{VISION_END}\n" for i in range(len(frames))
        )
        prompt = prompt.replace(f"{VISION_START}{VIDEO_PAD}{VISION_END}", frame_prompt)
        proc = processor(prompt, images=[np.asarray(frames[i]) for i in range(len(frames))])
        out = engine.generate(
            [Request(input_ids=proc.input_ids, pixel_patches=proc.pixel_patches,
                     grid_thw=proc.grid_thw, vision_token_id=cfg.image_token_id)],
            sampling,
        )[0]
        text = processor.decode(out["token_ids"], skip_special_tokens=True)
        if args.tiny_demo:
            # random weights emit unprintable ids; show the envelope instead
            print(f"[tiny-demo on {device}: {len(out['token_ids'])} tokens generated, "
                  f"{out['num_prompt_tokens']}-token prompt] {text!r}")
        else:
            print(text)


if __name__ == "__main__":
    main()

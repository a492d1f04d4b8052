"""A configuration, traffic mixes and limits small enough for the CPU,
with the geometry rules of the real ones."""

import copy
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def config(vocab: int = 32064) -> dict:
    cfg = json.loads((CONFIGS / "macaw-deepseek-llm-7b.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=4,
               vocab_size=vocab, max_position_embeddings=512)
    cfg["vision"].update(hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         image_size=32, patch_size=16, projection_dim=16)
    cfg["audio"].update(d_model=32, encoder_layers=2,
                        encoder_attention_heads=2, encoder_ffn_dim=64)
    cfg["fusion"].update(attention_heads=2, image_conv_kernel=2,
                         image_conv_stride=1, video_conv_kernel=6,
                         video_conv_stride=4)
    train = json.loads((CONFIGS / "macaw-baichuan-7b.json").read_text())
    cfg["training"] = copy.deepcopy(train["training"])
    return cfg


SERVE = {"kind": "serve", "arrival": {"rate_per_s": 8.0},
         "slots": 4, "prompt_bucket": 32,
         "prompt_tokens": {"min": 8, "max": 32, "dist": "log_uniform"},
         "answer_tokens": {"min": 3, "max": 8, "dist": "log_uniform"},
         "media": "all", "media_pool": 2, "ramp_s": 0.5,
         "check_requests": 4}

CHAT = dict(SERVE, media="none", media_pool=0)

TRAIN = {"kind": "train", "rows": 2, "text_tokens": 16, "media": "all",
         "batch_pool": 4, "checked_steps": 3, "total_steps": 20}

TRAIN_TEXT = dict(TRAIN, media="none")

# limits at this size, from its CPU readings: sound runs read widest gaps
# to 0.008 and the control 0.045 and more; training's sound gaps read to
# 2e-5 (loss) and 0.005 (norms), its control 1.9e-4 and 0.038 and more
SERVE_LIMITS = {"widest_gap": 0.02}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_norm_gap": 0.02,
                "first_grad_gap": 0.02, "change_gap": 0.02}

"""Prompt templates (the port's own copy of
``macaw_llm_tpu/data/templates.py``: the Alpaca-style instruction prompts
the model was tuned on)."""

PROMPT_INPUT = (
    "Below is an instruction that describes a task, paired with an input "
    "that provides further context. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{}\n\n### Input:\n{}\n\n### Response:"
)

PROMPT_NO_INPUT = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{}\n\n### Response:"
)


def format_prompt(instruction: str, input_text: str = "") -> str:
    if input_text:
        return PROMPT_INPUT.format(instruction, input_text)
    return PROMPT_NO_INPUT.format(instruction)


def format_full(instruction: str, input_text: str, output: str) -> str:
    """Prompt + target with the training data's exact join:
    prompt + '\\n {output} \\n\\n'."""
    return format_prompt(instruction, input_text) + "\n {} \n\n".format(output)

"""LoRA fine-tuning on a frozen quantized base, and the quality recipe's
tiny pretraining."""

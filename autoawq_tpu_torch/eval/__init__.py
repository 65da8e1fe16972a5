"""Quality measures: perplexity and KL divergence against a reference."""

"""Quality measures: perplexity and KL divergence against a reference,
multiple-choice scoring and WER (``tasks``), the HumanEval harness
(``humaneval``) and an lm-evaluation-harness adapter
(``lm_eval_adapter``)."""

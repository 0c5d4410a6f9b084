from projectiontrainer_tpu_torch.generate.decode import GenerationConfig, generate

__all__ = ["GenerationConfig", "generate"]

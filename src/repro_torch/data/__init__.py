from repro_torch.data.pipeline import Prefetcher, SyntheticLMDataset

__all__ = ["Prefetcher", "SyntheticLMDataset"]

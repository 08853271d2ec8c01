from .dataset import TemporalGraphDataLoader, TemporalGraphDataset

from repro_torch.checkpoint.twotier import TwoTierCheckpoint  # noqa: F401

"""The headroom markers the disruption controller reads."""

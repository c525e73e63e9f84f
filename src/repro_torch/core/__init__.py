"""Core: the CD-BFL round, its codec, gossip and posterior."""

"""Architecture configs: ``base.ArchConfig`` and one file per ported arch."""

"""Data ingestion: binning, datasets, model text."""

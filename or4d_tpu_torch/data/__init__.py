"""Host-side data: vocabularies, scene preparation, padded scene batches."""

"""Offline data preparation, run once, file to file (counterpart of
meant_tpu/data_engineering/), with numpy and the standard library: no
pandas (the card's machine has none); PIL, langdetect, snscrape and
requests only where a function needs them, imported there.

  dataprep      daily tweets -> [SEP]-joined, hash-tokenized arrays
  image_prep    chart PNGs -> (c, 224, 224) float arrays; align_dates
  mosi_prep     CMU-MOSI aligned_50 pickle -> arrays, empty texts dropped
  prepare_vqa   VQA-v2 annotations -> the npz the vqa CLI reads
  snes          djiaNews merge, movement labels, 5-day shifted columns
  stocknet_prep per-ticker JSON-lines tweets -> daily text CSVs
  fetchers      tweet scraping and price download (network; never tested)
"""

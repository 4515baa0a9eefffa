"""IV-SLAM's training-data generation: supervised feature scoring
(feature_evaluator), unsupervised quality labels (unsupervised), the
dataset writer (dataset_creator) and the per-frame orchestrator (datagen)."""

#!/bin/bash
# SLURM launcher for evaluating the PyTorch port: restores the config's
# BEST checkpoint and runs the validation pass with the per-layer metrics,
# one task a card as deploy/torch/slurm_train.sh.
#
#   sbatch deploy/torch/slurm_test.sh configs/training/<dataset>/<exp>.yml [data_root]
#SBATCH --job-name=mask_bev_torch_test
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-task=1
#SBATCH --cpus-per-task=8
#SBATCH --time=12:00:00
#SBATCH --output=logs/%x-%j.out

set -euo pipefail
CONFIG=${1:?usage: sbatch deploy/torch/slurm_test.sh configs/training/<dataset>/<exp>.yml [data_root]}
DATA_ROOT=${2:-data}

export MASKBEV_COORDINATOR=${MASKBEV_COORDINATOR:-"$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1):29500"}

srun python train_mask_bev_torch.py --config "$CONFIG" --data-root "$DATA_ROOT" --test --device cuda
